"""MoE routing: the share (%) of the traced stretch's routed choices (the
program's per-expert count on the device, read at the stretch's two ends)
that land on the experts this card holds; a uniform router gives their
share of the experts, 50 for 8 of 16.

A check that routing is sound, not a yardstick to improve: the seeded
router fixes it, so no change of the program should move it.  Its
direction is only how it acts on throughput (fewer choices held, less
expert work on this card); a move means the routing changed, which the
cell's ``correct`` judges."""


def read(ctx):
    c = ctx["h"].counters
    routed, held = c.get("routed"), c.get("held")
    if not routed or held is None or not sum(routed):
        return None
    first, count = held
    return 100.0 * sum(routed[first:first + count]) / sum(routed)
