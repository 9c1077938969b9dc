"""Settle: K2 launches (the kernel's ``LAUNCHES`` counter) over the
window's rounds."""


def read(ctx):
    c = ctx["h"].counters
    if not c.get("rounds"):
        return None
    return c["k2_launches"] / c["rounds"]
