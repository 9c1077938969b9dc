"""Operations and bytes each kernel needs for one launch, from its shape.

Bytes count every input byte read once and every output byte written once
at the launch's shape, whatever the kernel reads again; operations count
one for each elementwise operation or transcendental call.  The bound of a
launch is the larger of its bytes at the HBM rate and its operations at the
float32 rate (NVIDIA H100 SXM data sheet, 700 W).  Frozen copies of the
counts ``chip_smoke.py`` states for K1, K2, K4 and K5.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def k1(m: int, fj: int, fs: int, t: int):
    """Scoring (K1, ``jasda_score``) of M rows: (bytes, operations).
    Reads the features (Fj + Fs), the grids (2 T) and lam, capacity, theta
    a row, and alpha, beta once; writes a float score and a bool a row."""
    n_bytes = m * (fj + fs + 2 * t + 3) * 4 + (fj + fs) * 4 + m * 4 + m
    n_ops = m * (2 * (fj + fs) + 4 + 8 * t + 2)
    return n_bytes, n_ops


def k2(w: int, lanes: int, fused: bool, m_pad: int = 0, transformed: bool = False):
    """The batched settle (K2, ``wis_batch``) of W rows of L lanes:
    (bytes, operations).  Fused, it reads a lane's pool index (4 bytes),
    mask (1) and predecessor (4) and the round's padded score vector (and
    its transform, if any); unfused, a lane's weight (4) and predecessor
    (4).  Writes a bool a lane and a float total a row."""
    lanes_total = w * lanes
    if fused:
        n_bytes = lanes_total * (4 + 1 + 4) + m_pad * 4 * (2 if transformed else 1)
    else:
        n_bytes = lanes_total * (4 + 4)
    n_bytes += lanes_total + w * 4
    return n_bytes, lanes_total * 3


def k5(b: int, t: int, d: int, size: int, h0: bool = False):
    """The linear scan (K5, ``linear_scan``): reads a and b, writes h and
    h_T (in the inputs' ``size`` bytes an element), reads h0 (float32)."""
    n_bytes = 3 * b * t * d * size + b * d * size + (b * d * 4 if h0 else 0)
    return n_bytes, 2 * b * t * d


def k5_bwd(b: int, t: int, d: int, size: int, h0: bool = False):
    """K5's backward (``linear_scan_bwd``): reads a, h and the cotangent gh,
    writes da and db; with h0, reads h0 and gh_T and writes dh0 (float32)."""
    n_bytes = 5 * b * t * d * size + (3 * b * d * 4 if h0 else 0)
    return n_bytes, 3 * b * t * d


def keys_seen(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """Sum over query rows of the keys each row sees (the unmasked (query,
    key) pairs of one head): row i, at position q_offset + i, sees keys
    [max(0, pos - window + 1), min(Sk, pos + 1)), the bounds dropped without
    a window or causality."""
    seen = 0
    for pos in range(q_offset, q_offset + sq):
        lo = max(0, pos - window + 1) if window is not None else 0
        hi = min(sk, pos + 1) if causal else sk
        seen += max(hi - lo, 0)
    return seen


def k4(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
       window, q_offset: int, size: int):
    """Flash attention (K4, ``flash_attention``) of one launch: (bytes,
    operations).  Reads Q and K, V at Hkv heads and writes O, each once, in
    the inputs' ``size`` bytes an element; 4 D operations a visible (query,
    key) pair and query head (Q Kᵀ and P V, a multiply and an add each).
    A bfloat16 launch's operations go at ``BF16_FLOPS_PER_S``, as PERF.md's
    K4 bounds take them, a float32 one's at ``F32_OPS_PER_S``."""
    n_bytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * size
    n_ops = 4 * b * hq * d * keys_seen(sq, sk, causal, window, q_offset)
    return n_bytes, n_ops
