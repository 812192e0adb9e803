"""Timeline export — Paraver traces (Fig. 7) and an ASCII Gantt fallback.

The paper integrates Extrae so the simulated schedule can be inspected in
Paraver; we emit a minimal but valid ``.prv`` (one "thread" per device slot,
state records per scheduled task) plus its ``.row``/``.pcf`` companions, and
an ASCII Gantt for terminals/CI logs.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from .simulator import ScheduledTask, SimResult

_US = 1e6  # Paraver time unit: microseconds


def _rows(result: SimResult) -> List[Tuple[str, int]]:
    """(pool, slot) rows in stable order, skipping zero-cost pass-throughs."""
    seen: Dict[Tuple[str, int], None] = {}
    for s in result.schedule:
        if s.pool != "-":
            seen.setdefault((s.pool, s.slot))
    return sorted(seen.keys())


def write_prv(result: SimResult, path_prefix: str) -> str:
    """Write ``<prefix>.prv`` / ``.row`` / ``.pcf``; returns the .prv path."""
    rows = _rows(result)
    row_index = {rs: i + 1 for i, rs in enumerate(rows)}
    names = sorted({s.name for s in result.schedule if s.pool != "-"})
    name_code = {n: i + 1 for i, n in enumerate(names)}
    total_us = max(1, int(round(result.makespan * _US)))

    records: List[str] = []
    for s in sorted(result.schedule, key=lambda s: (s.start, s.uid)):
        if s.pool == "-":
            continue
        thread = row_index[(s.pool, s.slot)]
        b, e = int(round(s.start * _US)), int(round(s.end * _US))
        # state record: 1:cpu:app:task:thread:begin:end:state
        records.append(f"1:{thread}:1:1:{thread}:{b}:{e}:{name_code[s.name]}")

    nthreads = len(rows)
    header = (f"#Paraver (01/01/2026 at 00:00):{total_us}_us:1({nthreads}):"
              f"1:1({nthreads}:1)")
    prv = path_prefix + ".prv"
    with open(prv, "w") as f:
        f.write(header + "\n")
        f.write("\n".join(records) + "\n")
    with open(path_prefix + ".row", "w") as f:
        f.write(f"LEVEL THREAD SIZE {nthreads}\n")
        for (pool, slot), idx in sorted(row_index.items(), key=lambda kv: kv[1]):
            f.write(f"{pool}.{slot}\n")
    with open(path_prefix + ".pcf", "w") as f:
        f.write("EVENT_TYPE\n0 90000001 Simulated task\nVALUES\n")
        for n, c in name_code.items():
            f.write(f"{c} {n}\n")
    return prv


def ascii_gantt(result: SimResult, width: int = 100,
                max_rows: int = 24) -> str:
    """Terminal rendering of the simulated schedule (per device slot)."""
    rows = _rows(result)[:max_rows]
    if not rows or result.makespan <= 0:
        return "(empty schedule)"
    scale = width / result.makespan
    by_row: Dict[Tuple[str, int], List[ScheduledTask]] = defaultdict(list)
    for s in result.schedule:
        if s.pool != "-" and (s.pool, s.slot) in set(rows):
            by_row[(s.pool, s.slot)].append(s)

    glyphs = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    names = sorted({s.name for s in result.schedule if s.pool != "-"})
    glyph = {n: glyphs[i % len(glyphs)] for i, n in enumerate(names)}

    lines = [f"makespan: {result.makespan * 1e3:.3f} ms   "
             f"(1 col = {result.makespan / width * 1e3:.3f} ms)"]
    label_w = max(len(f"{p}.{i}") for p, i in rows) + 1
    for (pool, slot) in rows:
        buf = [" "] * width
        for s in sorted(by_row[(pool, slot)], key=lambda s: s.start):
            b = min(width - 1, int(s.start * scale))
            e = min(width, max(b + 1, int(s.end * scale)))
            for x in range(b, e):
                buf[x] = glyph[s.name]
        lines.append(f"{pool}.{slot}".ljust(label_w) + "|" + "".join(buf) + "|")
    legend = "  ".join(f"{glyph[n]}={n}" for n in names)
    lines.append("legend: " + legend)
    return "\n".join(lines)
