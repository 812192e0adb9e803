"""State carried across from the JAX package: traces, reports, orders.

The estimator has no weights.  What a user of the JAX package has built up
is a saved trace (``Trace.save``), a map of kernel cost reports, and the
dispatch orders its replay library discovered (``ReplayLibrary.export``).
All three are plain data, and :func:`import_reference` turns them into the
port's own objects without importing the JAX package: the trace file is
read by the port's :meth:`~repro_torch.core.trace.Trace.load`, each report
is copied field by field, and each order payload is staged on a fresh
:class:`~repro_torch.core.replay.ReplayLibrary`, keyed by the graph's
content hash.  ``FrozenGraph.content_hash()`` is computed identically in
both packages, so an Explorer that builds the same graph finds its orders
and validates them against the graph before replaying any.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

from .core.hlsreport import KernelReport, ReportMap
from .core.replay import ReplayLibrary
from .core.trace import Trace

_REPORT_FIELDS = tuple(f.name for f in dataclasses.fields(KernelReport))


def _report(r: Any) -> KernelReport:
    vals = {name: getattr(r, name) for name in _REPORT_FIELDS}
    vals["resources"] = dict(vals["resources"])
    vals["meta"] = dict(vals["meta"])
    return KernelReport(**vals)


def import_reference(trace_path: str, reports: Mapping[Tuple[str, str], Any],
                     orders: Mapping[Tuple[str, str], Mapping]
                     ) -> Tuple[Trace, ReportMap, ReplayLibrary]:
    """``(trace, reports, library)`` for the port from the JAX package's
    state.

    ``trace_path`` is a file written by ``Trace.save``; ``reports`` maps
    ``(kernel, device_kind)`` to report objects with
    :class:`~repro_torch.core.hlsreport.KernelReport`'s fields;
    ``orders`` maps ``(graph content hash, policy)`` to the payload
    ``ReplayLibrary.export(graph_hash, policy)`` returned.  Pass the
    library to ``Explorer(order_library=...)``."""
    trace = Trace.load(trace_path)
    port_reports = {tuple(key): _report(r) for key, r in reports.items()}
    library = ReplayLibrary()
    for (graph_hash, policy), payload in orders.items():
        library.stage(graph_hash, policy, payload)
    return trace, port_reports, library
