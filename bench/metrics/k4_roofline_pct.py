"""Attention (K4, ``flash_attention``'s kernels) in serving prefills: the
bound time of the traced stretch's launches at their shapes
(``counts.kernels.k4``; bfloat16 at the tensor cores' rate) over their
kernel time; None where the trace's launches are not the counted ones."""
from bench.counts import kernels as counts

SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    shapes = h.counters["traced"].get("flash_attention.shapes", {})
    t, n = tr.kernel_seconds(lambda name: "flash_attention" in name)
    if t <= 0 or n != sum(shapes.values()):
        return None
    bound = 0.0
    for (b, hq, hkv, sq, sk, d, dt, causal, window, q_offset), k in shapes.items():
        n_bytes, n_ops = counts.k4(b, hq, hkv, sq, sk, d, causal, window,
                                   q_offset, SIZE[dt])
        rate = counts.BF16_FLOPS_PER_S if dt == "bfloat16" else counts.F32_OPS_PER_S
        bound += k * counts.bound_s(n_bytes, n_ops, rate)
    return 100.0 * bound / t
