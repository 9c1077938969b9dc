"""Model step, host enqueue: the program's ``engine.decode`` spans (the
token and position copies and the 64 layers' launches) in the traced
stretch, per decode step."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "engine.decode", ps.steps)
