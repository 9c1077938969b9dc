"""One reader a per-layer metric: ``read(ctx)`` returns the metric's value,
or None where the run has nothing to read it from.  ``ctx`` holds the
harness (``h``: spans, counters, window), the cell's output (``out``)
and the traced stretch (``trace``, None without one)."""
