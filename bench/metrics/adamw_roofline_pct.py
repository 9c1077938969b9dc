"""Optimizer (``grad_sumsq_kernel``, ``grad_sumsq_finish_kernel`` and
``adamw_update_kernel``): the bound time of the traced stretch's steps, at
the bytes ``bench/counts/optim.py`` counts for the cell's configuration and
3.35 TB/s, over the summed time of the kernels that start inside the
stretch's ``step`` ranges."""
from bench.counts import kernels, optim

NAMES = ("grad_sumsq_", "adamw_update_kernel")


def read(ctx):
    tr, h = ctx["trace"], ctx["h"]
    if tr is None:
        return None
    steps = tr.spans("step")
    t = sum(b - a for name, a, b in tr.kernels
            if any(k in name for k in NAMES)
            and any(s <= a < e for s, e in steps)) / 1e9
    if t <= 0:
        return None
    c = dict(h.config)
    c.update(h.params.get("config_overrides", {}))
    return 100.0 * len(steps) * kernels.bound_s(optim.step_bytes(c), 0) / t
