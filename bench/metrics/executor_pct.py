"""Executor: the share of the window outside the job's chunk calls
(``step_fn``): the executor's rounds, its bookkeeping and its waits.  A
chunk counts for the part of it inside the window (the window closes
inside its last chunk)."""


def read(ctx):
    h = ctx["h"]
    inside = sum(min(b, h.t_close) - max(a, h.t_open)
                 for a, b in h.spans.get("chunk", ())
                 if b > h.t_open and a < h.t_close)
    if inside <= 0:
        return None
    return 100.0 * (h.window_s - inside) / h.window_s
