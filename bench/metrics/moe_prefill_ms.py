"""MoE layers in prefills: the device time of the activities the program
launched inside its ``model.moe`` ranges (routing, the held experts' rows,
the sum of their parts) in the traced stretch, per ``engine.prefill``
range there.  The layer's wait for the host's read of its routed counts is
no device time, and the launches of other layers are not counted."""


def read(ctx):
    c = ctx["h"].counters
    s, n = c.get("moe_prefill_device_s"), c.get("moe_prefills")
    if not s or not n:
        return None
    return 1e3 * s / n
