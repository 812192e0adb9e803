"""One-stop exploration driver: ``python -m repro_torch.explore <trace> ...``.

The examples and benchmarks used to re-implement the same driver glue —
load a trace, build a report map, enumerate a slot-count × ±SMP candidate
ramp, pick an engine, dump the ranking.  This module is that glue, once:

    python -m repro_torch.explore trace.jsonl --reports reports.json \\
        --cache-dir .sweeps --accs 1-16 --top-k 5

    python -m repro_torch.explore synth:40 --engine batch --top-k 3 --json out.json

The default engine is ``torch`` on ``--device cuda``: without a card it
exits with an error (``--device cpu`` runs the torch engine on the
host, ``--engine batch`` the exact numpy engine).  The sweep service's
``serve`` and ``client`` subcommands are not ported yet and are refused.

The positional trace is either a JSONL file written by
:meth:`repro_torch.core.trace.Trace.save` or ``synth:N`` — the deterministic
:func:`repro_torch.testing.synth.synth_trace` workload with its built-in report
(handy for smoke tests and demos; ``--reports`` is then optional).
``--reports`` is a JSON list of kernel cost reports::

    [{"kernel": "mxm_block", "device_kind": "fpga:mxm64",
      "compute_s": 1e-4, "dma_in_s": 1e-5, "dma_out_s": 2e-5,
      "resources": {"dsp": 100.0}}]

Candidates are the CEDR-style ramp every engine groups into one
``FrozenGraph`` family per eligibility: one candidate per (slot count ×
±SMP), slot counts from ``--accs`` (``1-8`` or ``1,2,4``).  Output is a
single JSON document (stdout, or ``--json PATH``): the ranked top-k with
makespans and bottlenecks, cache counters, wall-time ``timings``, and the
batch engines' replay telemetry (order hits, diverged / rescued /
serial-fallback lanes) — with ``--cache-dir`` a repeat invocation starts
warm from the on-disk graph, sim and dispatch-order stores.

The request/response shapes and candidate-ramp construction live in
:mod:`repro_torch.serve.protocol` so the CLI and the server can never drift.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import DeviceError, default_device
from .core.explore import (Candidate, ENGINE_NAMES, Explorer,
                           MAX_CHUNK_RETRIES)
from .core.hlsreport import KernelReport
from .core.replay import MAX_RESCUE_ROUNDS
from .core.trace import Trace
from .serve.protocol import (build_candidates, parse_accs,
                             parse_budget_args, parse_objectives,
                             reports_from_entries, sweep_doc, timings_block)


def _parse_accs(spec: str) -> List[int]:
    """``"1-8"`` or ``"1,2,4"`` (or a mix) -> sorted distinct counts."""
    return parse_accs(spec)


def _load_reports(path: str) -> Dict[Tuple[str, str], KernelReport]:
    with open(path) as f:
        entries = json.load(f)
    try:
        return reports_from_entries(entries)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}")


def _build_candidates(reports: Dict[Tuple[str, str], KernelReport],
                      accs: Sequence[int], smp: bool) -> List[Candidate]:
    return build_candidates(reports, accs, smp)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("serve", "client"):
        print(f"error: the {argv[0]!r} subcommand (the sweep service) is "
              f"not ported to repro_torch yet; use "
              f"'python -m repro.explore {argv[0]}'", file=sys.stderr)
        return 2

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description="Rank co-design candidates for one trace.")
    ap.add_argument("trace", help="Trace JSONL (Trace.save) or synth:N")
    ap.add_argument("--reports", metavar="PATH",
                    help="JSON list of kernel cost reports "
                         "(optional for synth:N traces)")
    ap.add_argument("--engine", choices=ENGINE_NAMES, default="torch",
                    help="evaluation engine (default %(default)s)")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=default_device(),
                    help="device of the torch engine (default "
                         "%(default)s; never replaced by another)")
    ap.add_argument("--policy", choices=("availability", "eft"),
                    default="availability")
    ap.add_argument("--accs", default="1-8", metavar="SPEC",
                    help="accelerator slot counts, e.g. 1-8 or 1,2,4 "
                         "(default %(default)s)")
    ap.add_argument("--no-smp", action="store_true",
                    help="drop the ±SMP eligibility axis")
    ap.add_argument("--top-k", type=int, default=5, metavar="K")
    ap.add_argument("--prune", action="store_true",
                    help="branch-and-bound pruning: composes with every "
                         "engine — on batch/torch, lanes whose bound "
                         "crosses the top-k incumbent retire mid-sweep "
                         "(reported as pruned, never ranked)")
    ap.add_argument("--objectives", metavar="AXES", default=None,
                    help="comma-separated PPA objective axes "
                         "(makespan_s, area_mm2, power_w, energy_j); "
                         "switches the sweep to Pareto-frontier output")
    ap.add_argument("--budget", metavar="AXIS=VALUE", action="append",
                    default=None, dest="ppa_budgets",
                    help="PPA budget bound, repeatable (e.g. "
                         "--budget power_w=2.5 --budget area_mm2=18); "
                         "budgeted axes join the objectives")
    ap.add_argument("--processes", type=int, default=0, metavar="N",
                    help="worker processes (exact engines only)")
    ap.add_argument("--cache-dir", metavar="DIR",
                    help="persistent graph/sim/order store — repeat "
                         "invocations start warm")
    ap.add_argument("--max-rescue-rounds", type=int,
                    default=MAX_RESCUE_ROUNDS, metavar="N",
                    help="order discoveries per candidate group "
                         "(default %(default)s)")
    ap.add_argument("--candidate-timeout", type=float, default=None,
                    metavar="S",
                    help="per-candidate evaluation deadline in seconds; "
                         "offenders retry once serially, then quarantine")
    ap.add_argument("--sweep-deadline", type=float, default=None,
                    metavar="S",
                    help="whole-sweep wall deadline in seconds; candidates "
                         "left when it expires are quarantined, not ranked")
    ap.add_argument("--max-retries", type=int, default=MAX_CHUNK_RETRIES,
                    metavar="N",
                    help="chunk re-submissions after a worker crash before "
                         "per-candidate isolation (default %(default)s)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the result document here instead of stdout")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    # operational failures (bad paths, corrupt inputs, invalid specs) are
    # one-line diagnostics on stderr + exit 2, never a traceback — this is
    # the sweep driver CI and scripts call in a loop
    try:
        if args.trace.startswith("synth:"):
            from .testing.synth import synth_reports, synth_trace
            trace = synth_trace(int(args.trace.split(":", 1)[1]))
            reports = _load_reports(args.reports) if args.reports \
                else synth_reports()
        else:
            trace = Trace.load(args.trace)
            if not args.reports:
                ap.error("--reports is required for a file trace")
            reports = _load_reports(args.reports)
        cands = _build_candidates(reports, _parse_accs(args.accs),
                                  smp=not args.no_smp)
        objectives = parse_objectives(args.objectives)
        budgets = parse_budget_args(args.ppa_budgets)
        ex = Explorer(trace, reports, policy=args.policy,
                      engine=args.engine,
                      device=args.device if args.engine == "torch" else None,
                      processes=args.processes,
                      cache_dir=args.cache_dir,
                      max_rescue_rounds=args.max_rescue_rounds,
                      candidate_timeout=args.candidate_timeout,
                      sweep_deadline=args.sweep_deadline,
                      max_retries=args.max_retries,
                      objectives=objectives, budgets=budgets)
    except (OSError, ValueError, KeyError, TypeError, DeviceError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    result = ex.explore(cands, top_k=args.top_k, prune=args.prune)

    doc = sweep_doc(args.trace, args.engine, ex, result, len(cands),
                    args.top_k)
    # one-shot runs have no admission queue; queue_s stays 0.0 so the
    # block means the same thing here and in a sweepd response
    doc["timings"] = timings_block(0.0, result.wall_seconds,
                                   time.perf_counter() - t0)
    if result.failed:
        print(f"quarantined {len(result.failed)} candidate(s):",
              file=sys.stderr)
        for o in result.failed:
            print(f"  {o.name}: {o.error}", file=sys.stderr)
    if ex.engine != args.engine:
        print(f"engine degraded: {args.engine} -> {ex.engine} "
              f"({doc['faults']['engine_demotions']} demotion(s))",
              file=sys.stderr)
    text = json.dumps(doc, indent=2)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.json}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
