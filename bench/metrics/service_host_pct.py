"""Event loop: the share of the traced stretch inside the program's
``service.event`` spans (arrivals, completions, heartbeats, policing,
``launch_due``) less their ``service.round`` spans."""
from bench import program_spans as ps


def read(ctx):
    return ps.share_pct(ctx, "service.event", less="service.round")
