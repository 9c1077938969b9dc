"""Settle (K2, ``wis_batch_kernel``): the bound time of the traced
stretch's launches over their kernel time.  A fused launch reads its
round's padded score vector, which the round's scoring launch wrote at
the same M: the stretch's fused launches read the K1 launches' rows."""
from bench.counts import kernels as counts


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    traced = h.counters["traced"]
    shapes = {k: n for k, n in traced.get("wis_dp.shapes", {}).items()
              if len(k) == 4}
    k1 = traced.get("jasda_score.shapes", {})
    t, n = tr.kernel_seconds(lambda name: "wis_batch_kernel" in name)
    fused = sum(n_ for (w, l, f, tf), n_ in shapes.items() if f)
    if t <= 0 or n != sum(shapes.values()) or fused != sum(k1.values()):
        return None
    bound = sum(k * counts.bound_s(*counts.k2(w, l, f, 0, tf))
                for (w, l, f, tf), k in shapes.items())
    bound += sum(k * m * 4 for (m, _, _, _), k in k1.items()) / counts.HBM_BYTES_PER_S
    return 100.0 * bound / t
