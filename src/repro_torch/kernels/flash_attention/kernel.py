"""Flash attention as hand-written CUDA kernels (K4).

Replaces ``repro/kernels/flash_attention/kernel.py::mha_pallas`` (body
``_attn_kernel``).  Source: ``kernels/csrc/flash_attention.cu`` (its header
says what bounds each path on an H100 and what the design does about it).
One C entry point takes one of two kernels:

* bfloat16 at head dims 64, 128 and 256 runs on the tensor cores: one block
  per 128 query rows of one (batch, kv head) in two warpgroups, K/V tiles
  of 64 keys (128 at head dim 128) brought by TMA into a 2-stage ring,
  S = Q Kᵀ and O += P V by ``wgmma``, the online softmax in float32
  registers (``mha_tiled_reference`` in ref.py models its arithmetic);
* float32 at any head dim, and bfloat16 at 16 and 32, run on the CUDA cores:
  one block per 32 rows, one warp per 4 rows, float32 FMAs.

Both order a block's rows (position, head in group), so the q heads of a kv
head share each K/V tile, and skip key tiles that no row of the block can
see.  Any Sq and Sk work; the output has q's dtype.

``mha_cuda`` launches on ``torch.cuda.current_stream()``.  For tensors that
lie on the CPU it runs the plain torch version (ref.py) instead; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import mha_reference

__all__ = ["mha_cuda", "check_rows_see_keys", "LAUNCHES", "SHAPES",
           "HEAD_DIMS"]

#: kernel launches (the wrapper adds one where it launches, nowhere else)
LAUNCHES = {"flash_attention": 0}
#: (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, q_offset) -> launches
SHAPES: dict = {}
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, ctypes.c_float, _P],
    "flash_attention_launch_on": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, ctypes.c_float, _P],
    "flash_attention_path": [_I, _I],
}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("flash_attention", _SIGNATURES)


def check_rows_see_keys(sq: int, sk: int, *, causal: bool,
                        window: Optional[int], q_offset: int) -> None:
    """Raise ValueError where a query row would see no key at all.

    Row i sees keys [max(0, q_offset + i - window + 1), min(Sk, q_offset + i
    + 1)) (bounds dropped without a window or causality); both ends grow with
    i, so the first and the last row decide.
    """
    if sq == 0:
        return
    for qp in (q_offset, q_offset + sq - 1):
        lo = max(0, qp - window + 1) if window is not None else 0
        hi = min(sk, qp + 1) if causal else sk
        if lo >= hi:
            raise ValueError(
                f"query position {qp} sees no key (Sk={sk}, causal={causal}, "
                f"window={window}, q_offset={q_offset}): out of the kernel's "
                "contract")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel loads 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """softmax(q kᵀ · scale + mask) v for q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    n_batch, n_hq, sq, d = q.shape
    n_hkv, sk = k.shape[1], k.shape[2]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    check_rows_see_keys(sq, sk, causal=causal, window=window,
                        q_offset=q_offset)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    device = q.device
    if device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)
    if device.type != "cuda":
        raise ValueError(f"flash attention launches on a CUDA device, not "
                         f"{str(device)!r} (a meta tensor has no data)")

    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n_hkv == 0 or n_hq % n_hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {n_hq} and {n_hkv}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    check_tensor(q, "q", q.dtype, (n_batch, n_hq, sq, d), device)
    check_tensor(k, "k", q.dtype, (n_batch, n_hkv, sk, d), device)
    check_tensor(v, "v", q.dtype, (n_batch, n_hkv, sk, d), device)

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n_batch,
        n_hq, n_hkv, sq, sk, d, _DTYPES[q.dtype], int(causal),
        0 if window is None else int(window), int(q_offset), float(scale),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    key = (n_batch, n_hq, n_hkv, sq, sk, d, str(q.dtype).replace("torch.", ""),
           bool(causal), window, int(q_offset))
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return out
