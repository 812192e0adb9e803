"""Traffic drivers, one module per kind of load, named by a traffic
file's ``"driver"`` key.

A driver gives ``setup(ctx)`` (build the program's side and warm up every
shape the window will use), ``window(ctx, seconds, t0)`` (offer the load
from ``t0`` for ``seconds``, run what began inside to its end, and return
the answers) and ``close(ctx)``.  An answer is a dict: ``t0``, ``t1``
(seconds from the window's start), ``ok``, ``error``, ``expected`` (the
candidate dicts asked for), ``makespans`` and ``ranked`` (the program's),
and what the metrics read (``batch_stats``, ``timings``).
"""
