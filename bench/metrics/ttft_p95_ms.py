"""Engine: the 95th percentile, over the requests submitted in the window
that got their first token in it, of submission to first token (the
sample count is the harness's ``requests`` counter)."""
import numpy as np


def read(ctx):
    ttft = ctx["h"].counters.get("ttft")
    if not ttft:
        return None
    return 1e3 * float(np.percentile(ttft, 95))
