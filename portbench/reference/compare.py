"""The comparison that decides ``correct``.

Every answer of the window (a sweep's ranked candidates) is held against
the reference's makespans of the candidates it was asked to rank:

* ``gap``: the widest relative gap ``|program - reference| / reference``
  of a ranked candidate's makespan;
* ``rank_errors``: positions where the program's ranking and the
  reference's (a stable sort in submission order) name different
  candidates whose reference makespans differ by more than the
  configuration's ``makespan_rtol`` (closer ones are ties);
* ``missing``: candidates an answer does not rank, and answers that never
  came.

Each has a limit (``limits`` of the configuration, set from readings of
the program and of the control, ``PERF.md``); the run is correct when each
number is at or under its limit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

from .sim import Reference


def judge(answers: Sequence[Mapping], ref: Reference, rtol: float
          ) -> Dict[str, float]:
    """The three numbers over ``answers``, each a dict with ``expected``
    (candidate dicts in submission order), ``makespans`` (name ->
    program's makespan) and ``ranked`` (the program's order of names);
    an answer with ``ok`` false counts every candidate as missing."""
    gap, rank_errors, missing = 0.0, 0, 0
    for a in answers:
        names = [c["name"] for c in a["expected"]]
        if not a.get("ok"):
            missing += len(names)
            continue
        want = {c["name"]: ref.makespan(c) for c in a["expected"]}
        got = a["makespans"]
        missing += sum(1 for n in names if n not in got)
        for n in names:
            if n in got:
                gap = max(gap, abs(got[n] - want[n]) / want[n])
        ref_rank = sorted(names, key=lambda n: want[n])
        for x, y in zip(a["ranked"], ref_rank):
            if x != y and x in want and \
                    abs(want[x] - want[y]) > rtol * max(abs(want[x]),
                                                        abs(want[y])):
                rank_errors += 1
    return {"gap": gap, "rank_errors": float(rank_errors),
            "missing": float(missing)}


def control_answers(answers: Sequence[Mapping], ref32: Reference
                    ) -> List[Dict]:
    """The control put in the program's place: the same answers, each
    candidate's makespan worked out by the float32 reference and ranked
    by it."""
    out = []
    for a in answers:
        spans = {c["name"]: ref32.makespan(c) for c in a["expected"]}
        names = [c["name"] for c in a["expected"]]
        out.append({"ok": True, "expected": a["expected"],
                    "makespans": spans,
                    "ranked": sorted(names, key=lambda n: spans[n])})
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
