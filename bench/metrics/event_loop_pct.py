"""Event loop: the share of the window spent outside the calls into the
scheduler's round (``service/engine.py``)."""


def read(ctx):
    h = ctx["h"]
    inside = sum(b - a for a, b in h.in_window("round"))
    if not h.spans.get("round"):
        return None
    return 100.0 * (h.window_s - inside) / h.window_s
