"""Model step, device wait: the program's ``engine.logits`` spans (the wait
for the step and the copy of the logits to the host) in the traced
stretch, per decode step."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "engine.logits", ps.steps)
