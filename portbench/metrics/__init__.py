"""Per-layer metric readers, one module per metric, named as the metric.

Each module's ``read(run)`` takes the traced run's record (``answers``,
``counters``: the port's counters over the window, ``spans``: the host
spans, ``devtrace``: the device trace's reduction or None) and returns
the metric's value, or None when it finds nothing to read, in which case
the metric is left out of the result.
"""
