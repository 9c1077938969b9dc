"""Model step: the window's engine-step seconds less its prefills' (the
decode of every busy slot and the host's token picks), over its steps."""


def read(ctx):
    c = ctx["h"].counters
    if not c.get("steps"):
        return None
    return 1e3 * c["decode_s"] / c["steps"]
