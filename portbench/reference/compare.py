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

A top-k answer (one that carries ``top_k``, k, and ``pruned``, the names
the program's branch-and-bound retired unranked) ranks only what it did
not retire.  ``gap`` still covers every ranked candidate; ``rank_errors``
covers the first k positions against the reference's first k; ``missing``
counts each unranked candidate that is not in ``pruned``, or whose
reference makespan is below the reference's k-th best by more than a tie
(a member of the top k retired or lost).  A candidate that ties the k-th
best may be ranked or pruned.

Each has a limit (``limits`` of the configuration, set from readings of
the program and of the control, ``PERF.md``); the run is correct when each
number is at or under its limit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Set

from .sim import Reference


def judge(answers: Sequence[Mapping], ref: Reference, rtol: float
          ) -> Dict[str, float]:
    """The three numbers over ``answers``, each a dict with ``expected``
    (candidate dicts in submission order), ``makespans`` (name ->
    program's makespan) and ``ranked`` (the program's order of names),
    and for a top-k answer ``top_k`` and ``pruned``; an answer with ``ok``
    false counts every candidate as missing."""
    gap, rank_errors, missing = 0.0, 0, 0
    for a in answers:
        names = [c["name"] for c in a["expected"]]
        if not a.get("ok"):
            missing += len(names)
            continue
        want = {c["name"]: ref.makespan(c) for c in a["expected"]}
        got = a["makespans"]
        for n in names:
            if n in got:
                gap = max(gap, abs(got[n] - want[n]) / want[n])
        ref_rank = sorted(names, key=lambda n: want[n])
        ranked = a["ranked"]
        if "pruned" in a:
            k, pruned = min(a["top_k"], len(names)), set(a["pruned"])
            missing += sum(1 for n in names if n not in got
                           and _lost(n, pruned, want, ref_rank[k - 1], rtol))
            ranked, ref_rank = ranked[:k], ref_rank[:k]
        else:
            missing += sum(1 for n in names if n not in got)
        for x, y in zip(ranked, ref_rank):
            if x != y and x in want and _apart(want[x], want[y], rtol):
                rank_errors += 1
    return {"gap": gap, "rank_errors": float(rank_errors),
            "missing": float(missing)}


def _apart(x: float, y: float, rtol: float) -> bool:
    """Two reference makespans that differ by more than a tie."""
    return abs(x - y) > rtol * max(abs(x), abs(y))


def _lost(name: str, pruned: Set[str], want: Mapping[str, float],
          kth: str, rtol: float) -> bool:
    """An unranked candidate of a top-k answer that counts as missing:
    not reported pruned, or below the reference's k-th best (``kth``) by
    more than a tie."""
    return name not in pruned or (want[name] < want[kth] and
                                  _apart(want[name], want[kth], rtol))


def control_answers(answers: Sequence[Mapping], ref32: Reference
                    ) -> List[Dict]:
    """The control put in the program's place: the same answers, each
    candidate's makespan worked out by the float32 reference and ranked
    by it; a top-k answer's control ranks every candidate and retires
    none."""
    out = []
    for a in answers:
        spans = {c["name"]: ref32.makespan(c) for c in a["expected"]}
        names = [c["name"] for c in a["expected"]]
        ctl = {"ok": True, "expected": a["expected"], "makespans": spans,
               "ranked": sorted(names, key=lambda n: spans[n])}
        if "pruned" in a:
            ctl.update(top_k=a["top_k"], pruned=[])
        out.append(ctl)
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
