"""Engine, token pick: the program's ``engine.pick`` spans (the host argmax
over each active slot's logits) in the traced stretch, per decode step."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "engine.pick", ps.steps)
