"""Device sync: the program's ``device.wait`` spans (the host blocked on a
copy from the card, inside packing or settle) in the traced stretch, per
round settled."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "device.wait", ps.rounds)
