"""Hand-written CUDA kernels for the port's hot spots (H100).

Each kernel subpackage mirrors its TPU counterpart in ``repro.kernels``:
  kernel.py — the ctypes wrapper of a CUDA C++ kernel in ``csrc/`` (built
              with nvcc for sm_90a on first use) plus its launch counter
  ops.py    — the dispatch wrapper (padding, buckets, device, fault hooks)
  ref.py    — the plain torch version, in the kernel's arithmetic order

Kernels:
  flash_attention — online-softmax attention (GQA, causal, sliding window)
  linear_scan     — the diagonal recurrence of the mamba / RG-LRU prefill
  jasda_score     — paper §4.2: batched variant scoring + FMP safety
  wis_dp          — paper §4.4: weighted-interval-scheduling DP, batched
                    settle and single window
  adamw           — the train step's clip norm and AdamW update (no TPU
                    kernel: the reference's optimizer is plain jnp)
"""
from .flash_attention.ops import flash_attention  # noqa: F401
from .linear_scan.ops import linear_scan  # noqa: F401
from .jasda_score.ops import score_variants  # noqa: F401
from .wis_dp.ops import wis_clear  # noqa: F401
