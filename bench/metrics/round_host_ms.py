"""Round host path: a round's span less the device-busy time inside it,
averaged over the rounds of the traced stretch (the bench's round spans
on the profiler's clock)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    rounds = tr.spans("round")
    if not rounds:
        return None
    host = [(b - a) / 1e9 - tr.busy_between(a, b) for a, b in rounds]
    return 1e3 * sum(host) / len(host)
