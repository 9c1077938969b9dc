"""MoE routing: the busiest held expert's routed choices in the traced
stretch over the held experts' mean (1 when the load is even)."""


def read(ctx):
    c = ctx["h"].counters
    routed, held = c.get("routed"), c.get("held")
    if not routed or held is None:
        return None
    first, count = held
    mine = routed[first:first + count]
    if not sum(mine):
        return None
    return max(mine) * len(mine) / sum(mine)
