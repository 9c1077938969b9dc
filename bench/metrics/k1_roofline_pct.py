"""Scoring (K1, ``score_kernel``): the bound time of the traced stretch's
launches, from ``bench/counts`` at each launch's shape, over their kernel
time in the profiler."""
from bench.counts import kernels as counts


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    shapes = h.counters["traced"].get("jasda_score.shapes", {})
    t, n = tr.kernel_seconds(lambda name: "score_kernel" in name)
    if t <= 0 or n != sum(shapes.values()):
        return None
    bound = sum(k * counts.bound_s(*counts.k1(*shape))
                for shape, k in shapes.items())
    return 100.0 * bound / t
