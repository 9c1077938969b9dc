"""Commit and feedback: the program's ``round.commit`` spans (the commit
loop, ``build_feedback``, each agent's ``observe_feedback``) in the traced
stretch, per round settled."""
from bench import program_spans as ps


def read(ctx):
    return ps.per_unit_ms(ctx, "round.commit", ps.rounds)
