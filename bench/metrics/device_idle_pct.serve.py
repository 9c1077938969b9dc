"""Device: the share of the traced stretch of serving steps (prefills and decodes) with no
activity on the card."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
