"""Scan (K5 forward, ``linear_scan_kernel``) in serving prefills: the bound time
of the traced stretch's launches at their shapes over their kernel time."""
from bench.counts import kernels as counts

SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    shapes = h.counters["traced"].get("linear_scan.shapes", {})
    t, n = tr.kernel_seconds(lambda name: "linear_scan_kernel" in name)
    if t <= 0 or n != sum(shapes.values()):
        return None
    bound = sum(k * counts.bound_s(*counts.k5(b, s, d, SIZE[dt], h0))
                for (b, s, d, dt, h0), k in shapes.items())
    return 100.0 * bound / t
