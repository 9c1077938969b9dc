"""Hand-written CUDA kernels for the port's hot spots (H100).

Each kernel subpackage mirrors its TPU counterpart in ``repro.kernels``:
  kernel.py — the ctypes wrapper of a CUDA C++ kernel in ``csrc/`` (built
              with nvcc for sm_90a on first use) plus its launch counter
  ops.py    — the dispatch wrapper (padding, buckets, device, fault hooks)
  ref.py    — the plain torch version, in the kernel's arithmetic order

Kernels:
  jasda_score — paper §4.2: batched variant scoring + FMP safety
  wis_dp      — paper §4.4: batched weighted-interval-scheduling settle
  linear_scan — the diagonal recurrence of the mamba / RG-LRU prefill
"""
