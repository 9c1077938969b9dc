"""Scan backward (``linear_scan_bwd_kernel``): the bound time of the
traced stretch's launches over their kernel time.  The kernel counts its
launches but not their shapes; a backward launch has its forward's shape,
so the reader reads only a stretch whose forward launches share one."""
from bench.counts import kernels as counts

SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    traced = h.counters["traced"]
    shapes = traced.get("linear_scan.shapes", {})
    n_bwd = traced.get("linear_scan_bwd", 0)
    t, n = tr.kernel_seconds(lambda name: "linear_scan_bwd_kernel" in name)
    if t <= 0 or n != n_bwd or len(shapes) != 1:
        return None
    (b, s, d, dt, h0), = shapes
    return 100.0 * n * counts.bound_s(*counts.k5_bwd(b, s, d, SIZE[dt], h0)) / t
