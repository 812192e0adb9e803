"""Wire protocol for the sweep service — and the CLI's shared glue.

One JSON document in (:class:`SweepRequest`), one JSON document out
(:func:`sweep_doc`).  The request names a trace (``synth:N`` or inline
JSONL-style events), a kernel-report list, the candidate ramp
(``accs`` × ±SMP — the same CEDR-style ramp ``python -m repro_torch.explore``
builds), the engine/policy, and the client's latency budget; the
response is the CLI's report document plus service telemetry (queue /
sweep / total timings, granted engine, coalescing counters).

The candidate-construction helpers (:func:`parse_accs`,
:func:`build_candidates`, :func:`reports_from_entries`) live here and
are re-used by ``repro_torch.explore`` so the CLI and the server can never
drift apart on what a request means.  This module must stay importable
without torch's CUDA runtime (a server decides its pool start method
before any torch engine runs) and without a running server (the CLI imports it for the
``timings`` block of one-shot runs).
"""
from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.augment import Eligibility
from ..core.devices import zynq_system
from ..core.explore import Candidate, ENGINE_NAMES
from ..core.hlsreport import KernelReport
from ..core.hwspec import Budgets, normalize_objectives
from ..core.trace import Trace, TraceEvent

#: Default whole-request latency budget (queue wait + sweep) in seconds.
DEFAULT_BUDGET_S = 120.0
POLICIES = ("availability", "eft")

#: Largest per-kind accelerator slot count a request may ask for.  The
#: accs spec is server-reachable, so the bound is checked *before* any
#: range materializes: an uncapped ``"1-99999999999"`` would be a
#: remote OOM lever (tens of GB in one set build), breaking the "the
#: server never dies with a request" contract.
MAX_ACC_SLOTS = 1024

#: The CacheStats failure counters every telemetry surface exposes
#: (the CLI ``faults`` block, ``/healthz``, chaos CI assertions).
FAULT_KEYS = ("worker_retries", "pool_respawns", "chunk_timeouts",
              "quarantined", "engine_demotions", "cache_quarantined")

#: The CacheStats branch-and-bound retirement counters (``prune=True``
#: fused into the lockstep engines) — the CLI/server ``retire`` block
#: and the sweepd ``/healthz`` lifetime totals.
RETIRE_KEYS = ("retired_lanes", "retire_sweeps", "incumbent_updates")


class ProtocolError(ValueError):
    """Malformed request — the server answers HTTP 400, never a 500."""


# ---------------------------------------------------------------------------
# Candidate-ramp construction (shared with the repro_torch.explore CLI)
# ---------------------------------------------------------------------------


def parse_accs(spec: str) -> List[int]:
    """``"1-8"`` or ``"1,2,4"`` (or a mix) -> sorted distinct counts,
    each capped at :data:`MAX_ACC_SLOTS` (checked before the range is
    materialized — see the constant's note)."""
    out = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, hi_s = part.split("-", 1)
            lo, hi = int(lo_s), int(hi_s)
            if hi > MAX_ACC_SLOTS:
                raise ValueError(f"accs range {part!r} exceeds the "
                                 f"{MAX_ACC_SLOTS}-slot cap")
            out.update(range(max(lo, 1), hi + 1))
        else:
            n = int(part)
            if n > MAX_ACC_SLOTS:
                raise ValueError(f"acc count {n} exceeds the "
                                 f"{MAX_ACC_SLOTS}-slot cap")
            out.add(n)
    counts = sorted(c for c in out if c >= 1)
    if not counts:
        raise ValueError(f"no slot counts in accs spec {spec!r}")
    return counts


def parse_objectives(spec: Optional[str]) -> Optional[List[str]]:
    """``"area_mm2,energy_j"`` -> axis-name list (validated downstream by
    :func:`~repro_torch.core.hwspec.normalize_objectives`); None/empty -> None."""
    if spec is None:
        return None
    axes = [a.strip() for a in str(spec).split(",") if a.strip()]
    return axes or None


def parse_budget_args(pairs: Optional[Sequence[str]]
                      ) -> Optional[Dict[str, float]]:
    """Repeatable ``AXIS=VALUE`` CLI args -> budgets mapping (axis names
    and bounds are validated downstream by
    :class:`~repro_torch.core.hwspec.Budgets`); None/empty -> None."""
    if not pairs:
        return None
    out: Dict[str, float] = {}
    for pair in pairs:
        axis, sep, value = str(pair).partition("=")
        if not sep or not axis.strip():
            raise ValueError(f"budget {pair!r} is not AXIS=VALUE")
        try:
            out[axis.strip()] = float(value)
        except ValueError:
            raise ValueError(f"budget {pair!r}: {value!r} is not a number")
    return out


def reports_from_entries(entries: Sequence[dict]
                         ) -> Dict[Tuple[str, str], KernelReport]:
    """A JSON list of kernel cost reports -> ReportMap (unknown keys are
    dropped so clients may carry annotations)."""
    if not isinstance(entries, list):
        raise ValueError("expected a JSON list of kernel reports")
    fields = {f.name for f in dataclasses.fields(KernelReport)}
    reports: Dict[Tuple[str, str], KernelReport] = {}
    for e in entries:
        if not isinstance(e, dict):
            raise ValueError(f"kernel report entries must be objects, "
                             f"got {type(e).__name__}")
        rep = KernelReport(**{k: v for k, v in e.items() if k in fields})
        reports[(rep.kernel, rep.device_kind)] = rep
    if not reports:
        raise ValueError("no kernel reports")
    return reports


def build_candidates(reports: Dict[Tuple[str, str], KernelReport],
                     accs: Sequence[int], smp: bool) -> List[Candidate]:
    """The CEDR-style ramp: one candidate per (slot count × ±SMP), every
    engine groups them into one FrozenGraph family per eligibility."""
    kinds_by_kernel: Dict[str, List[str]] = {}
    for kernel, kind in reports:
        kinds_by_kernel.setdefault(kernel, []).append(kind)
    acc_kinds = sorted({kind for _, kind in reports})
    out: List[Candidate] = []
    for n_acc in accs:
        for with_smp in (False, True) if smp else (False,):
            name = f"{n_acc}acc" + ("+smp" if with_smp else "")
            elig = Eligibility({
                kernel: tuple(kinds) + (("smp",) if with_smp else ())
                for kernel, kinds in kinds_by_kernel.items()})
            out.append(Candidate(
                name=name,
                system=zynq_system(name, {k: n_acc for k in acc_kinds}),
                eligibility=elig))
    return out


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepRequest:
    """One sweep query, validated; raw field errors are ProtocolErrors."""

    trace: str = ""                 # "synth:N", or "inline" with events
    events: Optional[List[dict]] = None   # TraceEvent.to_json-style dicts
    reports: Optional[List[dict]] = None  # kernel report entries
    accs: str = "1-8"
    smp: bool = True
    engine: str = "batch"
    policy: str = "availability"
    top_k: int = 5
    prune: bool = False
    budget_s: float = DEFAULT_BUDGET_S
    candidate_timeout_s: Optional[float] = None
    # multi-objective PPA mode (optional): ranked axes and budget bounds.
    # The spec library itself is server-fixed — always derived from this
    # request's kernel reports (SpecLibrary.from_reports), never supplied
    # over the wire — so budgets/objectives select among existing
    # behaviours without adding a remote lever
    objectives: Optional[List[str]] = None
    budgets: Optional[Dict[str, float]] = None

    @staticmethod
    def from_json(raw: Any) -> "SweepRequest":
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", "replace")
        if isinstance(raw, str):
            try:
                raw = json.loads(raw or "{}")
            except ValueError as exc:
                raise ProtocolError(f"request body is not JSON: {exc}")
        if not isinstance(raw, dict):
            raise ProtocolError("request body must be a JSON object")
        known = {f.name for f in dataclasses.fields(SweepRequest)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ProtocolError(f"unknown request fields: "
                                f"{', '.join(unknown)}")
        req = SweepRequest(**raw)
        req.validate()
        return req

    def validate(self) -> None:
        if self.engine not in ENGINE_NAMES:
            raise ProtocolError(f"unknown engine {self.engine!r} "
                                f"(valid: {', '.join(ENGINE_NAMES)})")
        if self.policy not in POLICIES:
            raise ProtocolError(f"unknown policy {self.policy!r} "
                                f"(valid: {', '.join(POLICIES)})")
        if not isinstance(self.trace, str) or not self.trace:
            raise ProtocolError("trace must be 'synth:N' or 'inline'")
        if self.trace.startswith("synth:"):
            try:
                n = int(self.trace.split(":", 1)[1])
            except ValueError:
                raise ProtocolError(f"bad trace spec {self.trace!r}")
            if not 1 <= n <= 100_000:
                raise ProtocolError(f"synth trace size {n} out of range")
        elif self.trace == "inline":
            if not isinstance(self.events, list) or not self.events:
                raise ProtocolError("trace 'inline' needs a non-empty "
                                    "'events' list")
        else:
            raise ProtocolError(f"bad trace spec {self.trace!r} (the "
                                f"service takes 'synth:N' or 'inline' "
                                f"events, never a server-side path)")
        try:
            parse_accs(self.accs)
        except (ValueError, TypeError) as exc:
            raise ProtocolError(str(exc))
        if not isinstance(self.top_k, int) or self.top_k < 1:
            raise ProtocolError(f"top_k must be a positive int, "
                                f"got {self.top_k!r}")
        # strict prune knob: retirement decisions ride on this flag, so a
        # truthy-but-not-bool value ("no", 0.5, [1]) is a 400, never a
        # silently-coerced sweep mode
        if not isinstance(self.prune, bool):
            raise ProtocolError(f"prune must be a boolean, "
                                f"got {self.prune!r}")
        if not isinstance(self.smp, bool):
            raise ProtocolError(f"smp must be a boolean, "
                                f"got {self.smp!r}")
        try:
            self.budget_s = float(self.budget_s)
        except (TypeError, ValueError):
            raise ProtocolError(f"budget_s must be a number, "
                                f"got {self.budget_s!r}")
        if not 0 < self.budget_s <= 3600:
            raise ProtocolError(f"budget_s must be in (0, 3600], "
                                f"got {self.budget_s}")
        if self.candidate_timeout_s is not None:
            try:
                self.candidate_timeout_s = float(self.candidate_timeout_s)
            except (TypeError, ValueError):
                raise ProtocolError("candidate_timeout_s must be a number")
            if self.candidate_timeout_s <= 0:
                raise ProtocolError("candidate_timeout_s must be > 0")
        # strict PPA validation: unknown axes and non-positive/non-finite
        # bounds are a 400, never a silently-ignored knob
        if self.objectives is not None and (
                not isinstance(self.objectives, list)
                or not all(isinstance(a, str) for a in self.objectives)):
            raise ProtocolError("objectives must be a list of axis names")
        try:
            parsed = Budgets.from_mapping(self.budgets)
            if self.objectives is not None or parsed is not None:
                normalize_objectives(self.objectives, parsed)
        except ValueError as exc:
            raise ProtocolError(str(exc))

    # ------------------------------------------------------- materialize
    def materialize(self) -> Tuple[Trace, Dict[Tuple[str, str],
                                               KernelReport],
                                   List[Candidate]]:
        """Build the (trace, reports, candidates) triple this request
        describes.  Input-shaped failures surface as ProtocolError."""
        try:
            if self.trace.startswith("synth:"):
                from ..testing.synth import synth_reports, synth_trace
                trace = synth_trace(int(self.trace.split(":", 1)[1]))
                reports = reports_from_entries(self.reports) \
                    if self.reports else synth_reports()
            else:
                trace = trace_from_events(self.events)
                if not self.reports:
                    raise ProtocolError("reports are required for an "
                                        "inline trace")
                reports = reports_from_entries(self.reports)
            cands = build_candidates(reports, parse_accs(self.accs),
                                     smp=self.smp)
        except ProtocolError:
            raise
        except (ValueError, KeyError, TypeError) as exc:
            raise ProtocolError(str(exc))
        return trace, reports, cands


def trace_from_events(events: Sequence[dict]) -> Trace:
    """Inline events (the ``TraceEvent.to_json`` dict shape — what a
    ``Trace.save`` JSONL body holds per line) -> a Trace."""
    out = []
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ProtocolError(f"events[{i}] must be an object")
        try:
            out.append(TraceEvent.from_json(json.dumps(e)))
        except (TypeError, ValueError, KeyError) as exc:
            raise ProtocolError(f"events[{i}]: {exc}")
    return Trace(events=out)


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


def timings_block(queue_s: float, sweep_s: float,
                  total_s: float) -> Dict[str, float]:
    """The deadline-math block: ``queue_s`` admission wait (0.0 for the
    one-shot CLI), ``sweep_s`` the explore() wall time, ``total_s`` the
    whole request including parse/build/report."""
    return {"queue_s": round(float(queue_s), 6),
            "sweep_s": round(float(sweep_s), 6),
            "total_s": round(float(total_s), 6)}


def sweep_doc(trace_label: str, engine_requested: str, ex,
              result, n_candidates: int,
              top_k: Optional[int]) -> Dict[str, Any]:
    """The sweep report document — one shape for the CLI and the server.

    ``ex`` is the Explorer after the sweep (``ex.engine`` is the final,
    possibly demoted engine), ``result`` its ExplorationResult.

    In PPA mode (``result.objectives`` set) the document additionally
    carries ``objectives``/``budgets``/``frontier``/``dominated`` and the
    per-candidate objective values ride on each ``top`` entry; scalar-
    mode documents are byte-identical to the pre-PPA shape.
    """
    doc = {
        "trace": trace_label,
        "engine": engine_requested,
        # engine demotion is sticky; != requested when the sweep degraded
        "engine_final": ex.engine,
        "policy": ex.policy,
        "candidates": n_candidates,
        "wall_seconds": result.wall_seconds,
        "best": result.best_name,
        "top": [{"rank": o.rank, "name": o.name,
                 "makespan_s": o.makespan_s, "bottleneck": o.bottleneck}
                for o in result.top(top_k)],
        "infeasible": result.infeasible,
        "pruned": result.pruned,
        "failed": [{"name": o.name, "error": o.error}
                   for o in result.failed],
        "cache": dict(result.cache),
        "replay": ex.batch_stats.as_dict(),
        # this sweep's in-flight retirement telemetry (per-call deltas —
        # lanes retired mid-sweep by the branch-and-bound cutoff; the
        # counts stay 0 on unpruned sweeps)
        "retire": {k: int(result.cache.get(k, 0)) for k in RETIRE_KEYS},
        # lifetime fault counters (includes construction-time demotions,
        # which per-sweep result.cache deltas cannot see)
        "faults": {k: v for k, v in ex.stats.as_dict().items()
                   if k in FAULT_KEYS},
    }
    if result.objectives is not None:
        doc["objectives"] = list(result.objectives)
        doc["budgets"] = dict(result.budgets) if result.budgets else {}
        doc["frontier"] = [
            {"rank": o.rank, "name": o.name, "makespan_s": o.makespan_s,
             "objectives": dict(o.objectives or {}),
             "ppa": o.ppa}
            for o in result.frontier]
        doc["dominated"] = result.dominated_count
        for entry, o in zip(doc["top"], result.top(top_k)):
            entry["objectives"] = dict(o.objectives or {})
    return doc


def error_doc(message: str, **extra: Any) -> Dict[str, Any]:
    doc: Dict[str, Any] = {"error": str(message)}
    doc.update(extra)
    return doc


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------


def post_json(url: str, doc: Dict[str, Any],
              timeout: float = DEFAULT_BUDGET_S + 30.0
              ) -> Tuple[int, Dict[str, Any]]:
    """POST ``doc`` as JSON; return ``(status, response_doc)``.  Error
    statuses come back as documents too (the server always answers JSON);
    transport failures raise ``URLError``."""
    body = json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        try:
            payload = json.loads(exc.read().decode())
        except ValueError:
            payload = error_doc(f"HTTP {exc.code}")
        return exc.code, payload


def get_json(url: str, timeout: float = 10.0
             ) -> Tuple[int, Dict[str, Any]]:
    """GET a JSON endpoint (healthz/readyz); same contract as post_json."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        try:
            payload = json.loads(exc.read().decode())
        except ValueError:
            payload = error_doc(f"HTTP {exc.code}")
        return exc.code, payload
