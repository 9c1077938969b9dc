"""Model step in serving: the frozen model FLOPs of the window's prefill
and decode tokens (``bench/counts/model.py``: 2 N tokens) over the window
times 989e12, the H100 SXM data sheet's dense bfloat16 rate."""
from bench.counts.kernels import BF16_FLOPS_PER_S


def read(ctx):
    h = ctx["h"]
    flops = h.counters.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops / (h.window_s * BF16_FLOPS_PER_S)
