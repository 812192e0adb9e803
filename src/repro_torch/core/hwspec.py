"""Knob-based hardware spec library: PPA annotation and Pareto ranking.

The paper's co-design question is performance *under hardware budgets*:
the programmer picks an accelerator mix and slot count from synthesis
estimates of area and power, not from makespan alone.  This module is
the spec side of that loop — a discrete lookup from (accelerator kind,
slot count) to **area, static + dynamic power and achievable clock**,
lumos-``MPSoC``/``UCore`` style (budget object + tech-scaling ratios),
composed from the same :class:`~repro_torch.core.hlsreport.KernelReport`
resource vectors the fabric-feasibility check already consumes:

* :class:`KindSpec` — per-slot silicon cost of one accelerator kind,
  derived from its kernel report's resource vector (dsp/bram/lut ×
  per-resource area and dynamic-power constants) or written by hand.
* :class:`SpecLibrary` — the whole platform: a base (processing-system)
  spec plus one :class:`KindSpec` per kind, at one tech node.
  ``lookup(kind, n)`` is the discrete knob table;
  ``annotate(system, sim)`` turns one schedule-free
  :class:`~repro_torch.core.simulator.SimResult` into a :class:`PPA` record
  with a per-pool component breakdown.
* :class:`Budgets` — optional upper bounds on the PPA axes.  Area and
  peak power are *static* (pure spec arithmetic on the candidate's
  pools), so over-budget candidates are rejected before any graph is
  built; the energy bound composes with the exploration lower-bound
  pruner (``static_w × lower_bound_s > energy_j`` can never become
  feasible, so the prune is exact).
* :func:`dominates` / :func:`pareto_indices` — the dominance definition
  (componentwise ``<=`` with ``<`` somewhere, minimisation on every
  axis) and deterministic frontier extraction used by
  :class:`~repro_torch.core.explore.ExplorationResult`.

Objective axes are minimised and named with their units:
``makespan_s`` and ``energy_j`` derive from simulated floats (the torch
engine's rtol tier perturbs them — see ``replay.frontiers_equivalent``
for the frontier-stability contract), while ``area_mm2`` and ``power_w``
(peak) are spec arithmetic only and therefore identical across every
engine tier.

First-order model notes (documented, deliberate):

* The clock-scaling knob (routing pressure derates achievable clock as
  slot counts grow) annotates the **report** — effective clock and the
  serialised slowdown bound per component — but does not re-cost the
  simulated graph: task costs come from the measured kernel reports at
  nominal clock.  Dynamic *energy* is clock-invariant to first order
  (power ∝ f, time ∝ 1/f), so the energy axis is unaffected.
* Shared DMA machinery (``submit``/``dma_out``) is folded into the base
  spec; only device pools get their own component line.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from .devices import SystemConfig
from .diskcache import sha256_text
from .hlsreport import KernelReport

#: Canonical objective axes, in report order.  All are minimised.
OBJECTIVE_NAMES: Tuple[str, ...] = ("makespan_s", "area_mm2", "power_w",
                                    "energy_j")

#: Axes a budget may bound (``makespan_s`` is what the sweep optimises;
#: bounding it is the existing ``sweep_deadline`` machinery's job).
BUDGET_AXES: Tuple[str, ...] = ("area_mm2", "power_w", "energy_j")

#: Objective axes derived from simulated floats — perturbed at the torch
#: engine's rtol tier.  ``area_mm2``/``power_w`` are spec arithmetic on
#: the candidate's pool layout and identical across every engine.
NOISY_AXES: Tuple[str, ...] = ("makespan_s", "energy_j")

# Per-resource silicon constants at the base tech node (28 nm — the
# Zynq-7000 series the paper measures).  Calibrated so the full 7045
# fabric budget (900 DSP / 2452 KB BRAM / 218.6k LUT) lands at a
# plausible ~14 mm² of fabric and ~2.3 W of peak dynamic power.
BASE_TECH_NM = 28
RESOURCE_AREA_MM2: Mapping[str, float] = {
    "dsp": 2.4e-3, "bram_kb": 4.6e-3, "lut": 2.5e-6}
RESOURCE_DYNAMIC_W: Mapping[str, float] = {
    "dsp": 8.0e-4, "bram_kb": 6.0e-4, "lut": 3.0e-7}
#: Leakage per mm² of instantiated fabric at the base node.
STATIC_W_PER_MM2 = 0.02

#: Routing pressure derates the achievable accelerator clock as slot
#: counts grow (timing closure gets harder the fuller the fabric).  The
#: table is indexed by ``slots - 1`` and clamps to its last entry.
DEFAULT_CLOCK_SCALE: Tuple[float, ...] = (
    1.0, 1.0, 1.0, 1.0, 0.97, 0.97, 0.95, 0.95, 0.92)


@dataclasses.dataclass(frozen=True)
class TechNode:
    """Lumos-style scaling ratios relative to :data:`BASE_TECH_NM`."""

    node_nm: int
    area_scale: float      # area multiplier (density improves -> < 1)
    freq_scale: float      # achievable clock multiplier
    dynamic_scale: float   # dynamic power multiplier at nominal clock
    static_scale: float    # leakage-per-mm² multiplier


#: The discrete node table (45/32/28/22/16 — the lumos set plus the
#: paper's 28 nm baseline at identity).
TECH_NODES: Mapping[int, TechNode] = {
    45: TechNode(45, 2.40, 0.85, 1.25, 0.80),
    32: TechNode(32, 1.27, 0.94, 1.10, 0.92),
    28: TechNode(28, 1.00, 1.00, 1.00, 1.00),
    22: TechNode(22, 0.63, 1.10, 0.84, 1.25),
    16: TechNode(16, 0.36, 1.22, 0.68, 1.60),
}


@dataclasses.dataclass(frozen=True)
class KindSpec:
    """Per-slot silicon cost of one accelerator kind at the base node."""

    kind: str
    area_mm2: float                 # one slot's fabric area
    dynamic_w: float                # one slot at 100% activity, nominal clock
    static_w: Optional[float] = None  # default: area × STATIC_W_PER_MM2
    clock_scale: Tuple[float, ...] = DEFAULT_CLOCK_SCALE

    def __post_init__(self) -> None:
        if self.area_mm2 < 0 or self.dynamic_w < 0:
            raise ValueError(f"negative spec for kind {self.kind!r}")
        if not self.clock_scale or any(not 0 < c <= 1
                                       for c in self.clock_scale):
            raise ValueError(f"clock_scale for {self.kind!r} must be a "
                             f"non-empty tuple of factors in (0, 1]")

    @property
    def static_w_eff(self) -> float:
        return self.static_w if self.static_w is not None \
            else self.area_mm2 * STATIC_W_PER_MM2

    def clock_at(self, slots: int) -> float:
        """Discrete lookup: achievable clock fraction with ``slots``
        instantiated (clamped to the table's last entry)."""
        i = min(max(int(slots), 1), len(self.clock_scale)) - 1
        return self.clock_scale[i]

    @staticmethod
    def from_report(report: KernelReport) -> "KindSpec":
        """One slot's cost from the kernel's HLS resource vector."""
        area = sum(RESOURCE_AREA_MM2.get(r, 0.0) * float(v)
                   for r, v in (report.resources or {}).items())
        dyn = sum(RESOURCE_DYNAMIC_W.get(r, 0.0) * float(v)
                  for r, v in (report.resources or {}).items())
        return KindSpec(kind=report.device_kind, area_mm2=area,
                        dynamic_w=dyn)


@dataclasses.dataclass(frozen=True)
class PPA:
    """One candidate's annotated power/performance/area record.

    ``power_w`` is **peak** power (static + every pool's dynamic power
    at full activity) — spec arithmetic only, identical across engine
    tiers.  ``energy_j = static_w × makespan + Σ dynamic_w × busy`` uses
    the simulated makespan/busy floats, so it sits on the rtol tier with
    the makespan.  ``components`` maps pool name (plus ``"base"``) to
    its breakdown dict.
    """

    area_mm2: float
    static_w: float
    power_w: float
    energy_j: float
    makespan_s: float
    components: Dict[str, Dict[str, float]]

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def objectives(self) -> Dict[str, float]:
        return {"makespan_s": self.makespan_s, "area_mm2": self.area_mm2,
                "power_w": self.power_w, "energy_j": self.energy_j}


class SpecLibrary:
    """The platform spec: base (PS-side) costs + one KindSpec per kind.

    ``base_*`` covers everything outside the reconfigurable fabric: the
    ARM cores, fixed logic and the shared DMA machinery.  ``tech_nm``
    applies the :data:`TECH_NODES` ratios to every *fabric* number (the
    base PS is hard silicon and does not scale with the fabric node).
    """

    def __init__(self, kinds: Mapping[str, KindSpec], *,
                 base_area_mm2: float = 15.0, base_static_w: float = 0.30,
                 smp_dynamic_w: float = 0.70, tech_nm: int = BASE_TECH_NM,
                 name: str = "zynq"):
        if tech_nm not in TECH_NODES:
            raise ValueError(f"unknown tech node {tech_nm!r} "
                             f"(valid: {sorted(TECH_NODES)})")
        self.kinds: Dict[str, KindSpec] = dict(kinds)
        self.base_area_mm2 = float(base_area_mm2)
        self.base_static_w = float(base_static_w)
        self.smp_dynamic_w = float(smp_dynamic_w)
        self.tech_nm = int(tech_nm)
        self.tech = TECH_NODES[self.tech_nm]
        self.name = name
        self._sig: Optional[str] = None

    # ------------------------------------------------------------ lookup
    def lookup(self, kind: str, slots: int) -> Dict[str, float]:
        """The discrete knob table: totals for ``slots`` slots of
        ``kind`` at this library's tech node."""
        spec = self.kinds.get(kind)
        if spec is None:
            raise KeyError(f"no spec for accelerator kind {kind!r} "
                           f"(known: {sorted(self.kinds)})")
        n = max(int(slots), 0)
        t = self.tech
        return {
            "area_mm2": spec.area_mm2 * t.area_scale * n,
            "static_w": spec.static_w_eff * t.area_scale * t.static_scale
            * n,
            "dynamic_w": spec.dynamic_w * t.dynamic_scale * n,
            "clock_scale": spec.clock_at(n) * t.freq_scale,
        }

    # ---------------------------------------------------------- annotate
    def annotate(self, system: SystemConfig, makespan_s: float,
                 busy: Mapping[str, float],
                 pool_slots: Optional[Mapping[str, int]] = None) -> PPA:
        """PPA for one simulated candidate.

        ``busy`` is the schedule-free sim's per-pool busy seconds
        (slot-seconds, already summed across a pool's slots); pools the
        sim never touched may be absent and contribute zero dynamic
        energy.  Pools whose kinds have no spec entry (and the ``smp``
        pool) are charged at the base/SMP rates.
        """
        components: Dict[str, Dict[str, float]] = {}
        area = self.base_area_mm2
        static = self.base_static_w
        peak_dyn = 0.0
        dyn_j = 0.0
        for pool in system.pools:
            count = pool.count if pool_slots is None \
                else int(pool_slots.get(pool.name, pool.count))
            busy_s = float(busy.get(pool.name, 0.0))
            kind = next((k for k in pool.kinds if k in self.kinds), None)
            if kind is not None:
                look = self.lookup(kind, count)
                comp = {"kind": kind, "slots": float(count), **look,
                        "busy_s": busy_s,
                        "energy_j": look["dynamic_w"] / max(count, 1)
                        * busy_s}
                area += look["area_mm2"]
                static += look["static_w"]
                peak_dyn += look["dynamic_w"]
            else:
                # the SMP pool (and any unspec'd pool) rides the base
                # area/leakage; only its dynamic activity is charged
                comp = {"kind": pool.kinds[0] if pool.kinds else "smp",
                        "slots": float(count), "area_mm2": 0.0,
                        "static_w": 0.0,
                        "dynamic_w": self.smp_dynamic_w * count,
                        "clock_scale": 1.0, "busy_s": busy_s,
                        "energy_j": self.smp_dynamic_w * busy_s}
                peak_dyn += comp["dynamic_w"]
            dyn_j += comp["energy_j"]
            components[pool.name] = comp
        components["base"] = {
            "area_mm2": self.base_area_mm2, "static_w": self.base_static_w,
            "dynamic_w": 0.0, "busy_s": 0.0,
            "energy_j": self.base_static_w * makespan_s}
        return PPA(area_mm2=area, static_w=static,
                   power_w=static + peak_dyn,
                   energy_j=static * makespan_s + dyn_j,
                   makespan_s=makespan_s, components=components)

    def static_ppa(self, system: SystemConfig) -> Tuple[float, float]:
        """(area_mm2, peak power_w) — the simulation-free axes, used for
        pre-graph budget rejection."""
        ppa = self.annotate(system, 0.0, {})
        return ppa.area_mm2, ppa.power_w

    # --------------------------------------------------------- signature
    def signature(self) -> str:
        """Content token: two libraries with the same numbers share it.
        Namespaces every objective-dependent cache key (see
        ``Explorer._ppa_token``)."""
        if self._sig is None:
            doc = [self.name, self.tech_nm, self.base_area_mm2,
                   self.base_static_w, self.smp_dynamic_w,
                   sorted((k, s.area_mm2, s.dynamic_w, s.static_w_eff,
                           list(s.clock_scale))
                          for k, s in self.kinds.items())]
            self._sig = sha256_text(json.dumps(doc))
        return self._sig

    # ------------------------------------------------------ constructors
    @staticmethod
    def from_reports(reports: Mapping[Tuple[str, str], KernelReport],
                     tech_nm: int = BASE_TECH_NM,
                     name: str = "zynq") -> "SpecLibrary":
        """Compose the library from the sweep's own kernel reports: one
        :class:`KindSpec` per accelerator kind, sized by the largest
        resource vector any of its kernels synthesises to (one slot must
        hold the largest kernel it serves).  Deterministic in the report
        contents, so the CLI and the sweep server derive the identical
        library from the identical request."""
        per_kind: Dict[str, Dict[str, float]] = {}
        for (_, kind), rep in reports.items():
            if kind == "smp":
                continue
            acc = per_kind.setdefault(kind, {})
            for r, v in (rep.resources or {}).items():
                acc[r] = max(acc.get(r, 0.0), float(v))
        kinds = {}
        for kind, res in sorted(per_kind.items()):
            area = sum(RESOURCE_AREA_MM2.get(r, 0.0) * v
                       for r, v in res.items())
            dyn = sum(RESOURCE_DYNAMIC_W.get(r, 0.0) * v
                      for r, v in res.items())
            kinds[kind] = KindSpec(kind=kind, area_mm2=area, dynamic_w=dyn)
        return SpecLibrary(kinds, tech_nm=tech_nm, name=name)


# ---------------------------------------------------------------------------
# Budgets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Budgets:
    """Optional upper bounds on the PPA axes (all minimised, so a bound
    is always an upper bound).  A budgeted axis is automatically ranked
    (joined to the objective set): that is what makes budget tightening
    monotone — a dominator is at least as feasible as any candidate it
    dominates, so tightening can only *remove* frontier members."""

    area_mm2: Optional[float] = None
    power_w: Optional[float] = None
    energy_j: Optional[float] = None

    def __post_init__(self) -> None:
        for axis in BUDGET_AXES:
            v = getattr(self, axis)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(v) or v <= 0:
                raise ValueError(f"budget {axis} must be a positive finite "
                                 f"number, got {v!r}")

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a in BUDGET_AXES
                     if getattr(self, a) is not None)

    def as_dict(self) -> Dict[str, float]:
        return {a: float(getattr(self, a)) for a in self.axes()}

    def violation(self, values: Mapping[str, float]) -> Optional[str]:
        """First violated axis as a human-readable reason, else None.
        Axes absent from ``values`` are not checked."""
        for axis in self.axes():
            bound = float(getattr(self, axis))
            got = values.get(axis)
            if got is not None and got > bound:
                return f"{axis} {got:.6g} exceeds budget {bound:.6g}"
        return None

    @staticmethod
    def from_mapping(raw: Optional[Mapping[str, Any]]) -> \
            Optional["Budgets"]:
        """Strict parse: unknown axes and non-positive / non-finite
        values raise ValueError (the protocol layer maps this to a 400;
        there is no lenient mode — budgets are a remote-reachable
        surface)."""
        if raw is None:
            return None
        if not isinstance(raw, Mapping):
            raise ValueError(f"budgets must be a mapping of axis -> bound, "
                             f"got {type(raw).__name__}")
        unknown = sorted(set(raw) - set(BUDGET_AXES))
        if unknown:
            raise ValueError(f"unknown budget axes: {', '.join(unknown)} "
                             f"(valid: {', '.join(BUDGET_AXES)})")
        return Budgets(**{k: raw[k] for k in raw})


def normalize_objectives(objectives: Optional[Sequence[str]],
                         budgets: Optional[Budgets]) -> Tuple[str, ...]:
    """The effective objective axes, canonically ordered.

    Validates names, de-duplicates, always includes ``makespan_s`` (the
    primary axis every ranking/pruning contract is stated against) and
    joins every budgeted axis (see :class:`Budgets` for why).
    """
    req = list(objectives) if objectives is not None else []
    unknown = sorted(set(req) - set(OBJECTIVE_NAMES))
    if unknown:
        raise ValueError(f"unknown objectives: {', '.join(unknown)} "
                         f"(valid: {', '.join(OBJECTIVE_NAMES)})")
    chosen = set(req) | {"makespan_s"}
    if budgets is not None:
        chosen |= set(budgets.axes())
    return tuple(a for a in OBJECTIVE_NAMES if a in chosen)


# ---------------------------------------------------------------------------
# Pareto dominance
# ---------------------------------------------------------------------------


def dominates(a: Mapping[str, float], b: Mapping[str, float],
              axes: Sequence[str]) -> bool:
    """Strict Pareto dominance, minimising every axis: ``a`` is no worse
    everywhere and strictly better somewhere.  Equal points never
    dominate each other (both survive extraction — that is what makes
    the frontier permutation-invariant)."""
    better = False
    for axis in axes:
        av, bv = a[axis], b[axis]
        if av > bv:
            return False
        if av < bv:
            better = True
    return better


def pareto_indices(points: Sequence[Mapping[str, float]],
                   axes: Sequence[str]) -> List[int]:
    """Indices of the mutually non-dominated points, in input order.

    O(n²) pairwise — sweep sizes are hundreds to low thousands and the
    comparison is a handful of float compares.  Membership depends only
    on the point *values*, never on input order."""
    out: List[int] = []
    for i, p in enumerate(points):
        if not any(dominates(q, p, axes)
                   for j, q in enumerate(points) if j != i):
            out.append(i)
    return out
