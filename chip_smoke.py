#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's co-design sweep (``repro_torch``: trace -> augmented
task graph -> FrozenGraph -> candidate-axis lockstep replay -> ranked
ExplorationResult) with ``Explorer(engine="torch")`` on the card, through
the hand-written step-commit kernel, and holds every result against the
port's exact host engine (``engine="batch"``).  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit, torch's name, count);
2. the kernel build (seconds, ``-Xptxas -v`` registers and spills);
3. kernel == plain PyTorch version, bit for bit, on seeded states at the
   main path's shapes, with all-``inf`` pools and ties;
4. three sweeps: ``trace_matmul(512, 64)`` with a 200-candidate slot ×
   ±SMP ramp (cold, then warm from the recorded orders), the same sweep
   with ``top_k=5, prune=True``, and ``trace_cholesky(512, 64)`` with the
   six Fig. 9 designs each at 1..8 accelerator slots — each ranking must
   agree with the batch engine's at ``TORCH_RTOL`` with the same best
   candidate, no engine demotion, kernel launches > 0 and lanes that went
   through the lockstep path;
5. the kernel at every ``(P, S, B)`` the sweeps launched it at: kernel ==
   plain version, times by CUDA events and bound at each;
6. a warm Cholesky sweep plain and under ``torch.profiler`` (device busy
   share, kernels per step, the costliest host operations);
7. a ``kernels`` JSON line (launches on the sweeps, error against the
   plain version, times and bound at the commonest path shape) and
   candidates/s lines.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the port's sources beside this file, it prints no result and
exits non-zero.  Run: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: HBM3 rate of an H100 SXM (NVIDIA's data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12

#: (P, S, B) states the kernel is held to its plain version at before the
#: sweeps: a wide and deep state, a four-pool one and a ragged one.  After
#: the sweeps it is held again at every shape they launched it at.
KERNEL_SHAPES = ((2, 64, 256), (4, 16, 256), (3, 5, 128))


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_state(rng, P: int, S: int, B: int):
    """A commit's inputs: small integer clocks (many ties), pools that are
    all ``inf`` in some lanes, slots past a lane's count at ``inf``."""
    import numpy as np
    clocks = rng.integers(0, 4, (P, S, B)).astype(np.float64)
    clocks[:, (S + 1) // 2:, ::3] = np.inf
    clocks[P - 1, :, ::5] = np.inf
    busy = rng.random((P, B))
    seen = rng.random((P, B)) < 0.5
    p = rng.integers(0, P, B).astype(np.int64)
    rt = rng.integers(0, 4, B).astype(np.float64)
    base = rng.random(B)
    live = rng.random(B) < 0.75
    return clocks, busy, seen, p, rt, base, live


def compare(a, b):
    """``(bit-identical, max abs difference over finite entries)``; NaN
    and infinite entries must sit at the same places with equal values."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return torch.equal(a, b), 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = bool(((a == b) | both_nan).all())
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return same, err


def commit_bytes(S: int, B: int, n_live: int) -> int:
    """Bytes the commit must move, read once and written once: the S
    clocks of each lane's own pool, each lane's p, rt, base and live, the
    busy entry of each live lane (read and written), ``end`` for every
    lane, and one clock and one seen entry per live lane (in place).  The
    other pools' clocks, busy and seen are not touched, so P drops out."""
    reads = S * B * 8 + B * (8 + 8 + 8 + 1) + n_live * 8
    writes = B * 8 + n_live * (8 + 8 + 1)
    return reads + writes


def time_ms(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def kernel_check(ls, torch, np, shapes, label, seed):
    """Kernel == plain version at every ``(P, S, B)`` of ``shapes``, on
    seeded states; returns the worst finite error."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for P, S, B in shapes:
        host = [torch.from_numpy(a) for a in seeded_state(rng, P, S, B)]
        ref = [t.clone().cuda() for t in host]
        dev = [t.clone().cuda() for t in host]
        end_ref = ls.step_commit_ref(*ref)
        end_dev = ls.step_commit(*dev)
        torch.cuda.synchronize()
        results = [compare(x, y) for x, y in
                   zip(dev[:3] + [end_dev], ref[:3] + [end_ref])]
        ok = all(same for same, _ in results)
        err = max(e for _, e in results)
        worst = max(worst, err)
        n_inf = int(torch.isinf(host[0]).all(dim=1).sum())
        phase(label, f"P={P} S={S} B={B}: bit-identical={ok} "
              f"max_abs_err={err} (all-inf pool lanes: {n_inf})")
        if not ok:
            raise SystemExit(f"step_commit disagrees with step_commit_ref "
                             f"at {(P, S, B)}")
    return worst


def kernel_times(ls, torch, np, shape):
    """Kernel and plain-version times per call at ``shape``, on the same
    seeded inputs, by CUDA events; plus the bound."""
    P, S, B = shape
    rng = np.random.default_rng(1)
    host = [torch.from_numpy(a) for a in seeded_state(rng, P, S, B)]
    dev = [t.cuda() for t in host]
    n_live = int(host[6].sum())
    lib = ls._lib()
    end = torch.empty(B, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in dev] + [end.data_ptr()]

    def raw():
        lib.step_commit_launch(*ptrs, S, B, stream)

    wrapper_ms = time_ms(lambda: ls.step_commit(*dev), 2000)
    kernel_ms = time_ms(raw, 2000)
    plain_ms = time_ms(lambda: ls.step_commit_ref(*dev), 500)
    bound_ms = commit_bytes(S, B, n_live) / HBM_BYTES_PER_S * 1e3
    return {"shape": [P, S, B], "ms": wrapper_ms, "kernel_only_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": commit_bytes(S, B, n_live)}


def profile_sweep(torch, Explorer, trace, reports, a9, cands, library, ls):
    """Where a warm sweep's time goes on the card: the sweep once plain and
    once under ``torch.profiler``, both from ``library``'s recorded orders.
    Returns the plain wall, the device time of the profiled run's kernels,
    their count, the steps (step-commit launches) and the busiest ops."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        ex = Explorer(trace, reports, engine="torch", smp_seconds_fn=a9,
                      order_library=library)
        ls.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.explore(cands, top_k=3)
        torch.cuda.synchronize()
        return time.perf_counter() - t, ls.LAUNCHES

    wall, steps = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = run()
    events = prof.key_averages()
    dev = [e for e in events if "cuda" in str(e.device_type).lower()]
    device_s = sum(e.self_device_time_total for e in dev) * 1e-6
    n_kernels = sum(e.count for e in dev)
    top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:5]
    return {"wall_s": wall, "profiled_wall_s": prof_wall, "steps": steps,
            "device_s": device_s, "device_busy_share": device_s / wall,
            "kernels": n_kernels,
            "kernels_per_step": n_kernels / max(steps, 1),
            "top_host_ops": [[e.key, e.count, e.self_cpu_time_total * 1e-6]
                             for e in top_host]}


def cholesky_ramp(ch, zynq_system, Candidate, slots):
    """The six Fig. 9 designs, each at 1..``slots`` slots per accelerator
    pool, without fabric payload (this sweep exercises the engines, not
    the feasibility filter).  A design alone is a one-lane family, which
    the replay protocol runs serially; its slot ramp is a lockstep family.
    """
    out = []
    for base in ch.candidates(bs=64):
        for k in range(1, slots + 1):
            name = f"{base.name}x{k}"
            counts = {kind: n * k for kind, n
                      in base.system.meta["accelerators"].items()}
            out.append(Candidate(name=name,
                                 system=zynq_system(name, counts),
                                 eligibility=base.eligibility))
    return out


def matmul_ramp(mm, zynq_system, Eligibility, bs, count):
    """``count`` slot × ±SMP variants over one granularity (the fig6
    sweep shape)."""
    kind = f"fpga:mxm{bs}"
    out = []
    for n_acc in range(1, count // 2 + 1):
        for smp in (False, True):
            name = f"{n_acc}acc{bs}" + ("+smp" if smp else "")
            kinds = (kind, "smp") if smp else (kind,)
            out.append(mm.Candidate(
                name=name, system=zynq_system(name, {kind: n_acc}),
                eligibility=Eligibility({"mxm_block": kinds})))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.apps import cholesky as ch
    from repro_torch.apps import matmul as mm
    from repro_torch.core import Explorer, a9_smp_seconds, zynq_system
    from repro_torch.core.augment import Eligibility
    from repro_torch.core.explore import Candidate
    from repro_torch.core.replay import TORCH_RTOL, rankings_equivalent
    from repro_torch.kernels import build
    from repro_torch.kernels import lockstep_step as ls

    # 1. the card
    power_line = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("card", f"{power_line} | torch: {kind} x{count} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")

    # 2. the kernel build
    t0 = time.perf_counter()
    ls._lib()
    info = build.BUILD_INFO[ls.SOURCE]
    ptxas = "; ".join(info["ptxas"].splitlines()) or "(no ptxas report)"
    phase("build", f"{ls.SOURCE} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s):"
          f" {ptxas}")

    # 3. kernel vs plain version on the card
    worst_err = kernel_check(ls, torch, np, KERNEL_SHAPES, "kernel==plain", 0)

    # 4. the sweeps: torch on the card, then batch on the host
    sweeps = []
    mm_tr = mm.trace_matmul(n=512, bs=64)
    mm_rep = mm.report_map()
    mm_a9 = a9_smp_seconds("float32")
    mm_cands = matmul_ramp(mm, zynq_system, Eligibility, 64, 200)
    ch_tr = ch.trace_cholesky(n=512, bs=64)
    ch_rep = ch.report_map(bs=64)
    ch_a9 = a9_smp_seconds("float64")
    ch_cands = cholesky_ramp(ch, zynq_system, Candidate, 8)
    libs = {}
    path_shapes = Counter()     # (P, S, B) of the sweeps' kernel launches

    def sweep(label, trace, reports, a9, cands, *, top_k, prune=False,
              warm_from=None):
        """One sweep on both engines; ``warm_from`` names an earlier sweep
        whose recorded orders this one starts from (fresh Explorers, so no
        simulation cache hit short-cuts the engines)."""
        res = {}
        for engine in ("torch", "batch"):
            lib = libs.get((warm_from, engine)) if warm_from else None
            ex = Explorer(trace, reports, engine=engine, smp_seconds_fn=a9,
                          order_library=lib)
            ls.LAUNCHES = 0
            ls.SHAPES.clear()
            t = time.perf_counter()
            r = ex.explore(cands, top_k=top_k, prune=prune)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            libs[(label, engine)] = ex.order_library
            res[engine] = (ex, r, wall, ls.LAUNCHES)
            if engine == "torch":
                path_shapes.update(ls.SHAPES)
        (ex_t, r_t, w_t, launches), (ex_b, r_b, w_b, host_launches) = \
            res["torch"], res["batch"]
        got = [o.name for o in r_t.ranked]
        want = [o.name for o in r_b.ranked]
        spans = {o.name: o.makespan_s for o in r_b.ranked}
        bst = ex_t.batch_stats.as_dict()
        ok_out = [o for o in r_t.outcomes if o.status == "ok"]
        checks = {
            "ok_rankings_equivalent": rankings_equivalent(got, want, spans,
                                                          TORCH_RTOL),
            "ok_same_best": r_t.best_name == r_b.best_name,
            "ok_no_demotion": ex_t.stats.engine_demotions == 0
            and ex_t.engine == "torch",
            "ok_launches": launches > 0 and host_launches == 0,
            "ok_lockstep_lanes": bst["lockstep_lanes"] > 0,
            "ok_outcomes": len(r_t.outcomes) == len(cands)
            and all(np.isfinite(o.makespan_s) and o.makespan_s > 0
                    for o in ok_out),
        }
        row = {"sweep": label, "trace_tasks": len(trace),
               "candidates": len(cands), "best": r_t.best_name,
               "launches": launches, "torch_s": w_t, "batch_s": w_b,
               "torch_cand_per_s": len(cands) / w_t,
               "batch_cand_per_s": len(cands) / w_b,
               "launches_per_s": launches / w_t,
               "lockstep_lanes": bst["lockstep_lanes"],
               "reference_lanes": bst["reference_lanes"],
               "retired_lanes": bst["retired_lanes"],
               "demotions": ex_t.stats.engine_demotions, **checks}
        phase("sweep", json.dumps(row))
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise SystemExit(f"sweep {label}: failed {bad}")
        sweeps.append(row)

    sweep("matmul512_200_cold", mm_tr, mm_rep, mm_a9, mm_cands, top_k=5)
    sweep("matmul512_200_warm", mm_tr, mm_rep, mm_a9, mm_cands, top_k=5,
          warm_from="matmul512_200_cold")
    sweep("cholesky512_48_cold", ch_tr, ch_rep, ch_a9, ch_cands, top_k=3)
    sweep("matmul512_200_top5_prune", mm_tr, mm_rep, mm_a9, mm_cands,
          top_k=5, prune=True)

    # 5. the kernel at the shapes the sweeps launched it at: kernel ==
    # plain version at each, times at each (and at the first check shape,
    # for comparison), the line's at the commonest
    shapes = [sh for sh, _ in path_shapes.most_common()]
    phase("path shapes", "; ".join(f"P,S,B={sh}: {n} launches"
                                   for sh, n in path_shapes.most_common()))
    worst_err = max(worst_err, kernel_check(ls, torch, np, shapes,
                                            "kernel==plain on path", 2))
    by_shape = []
    for sh in shapes + [x for x in KERNEL_SHAPES[:1] if x not in shapes]:
        t = kernel_times(ls, torch, np, sh)
        t["launches"] = path_shapes[sh]
        by_shape.append(t)
        phase("kernel", f"step_commit at P,S,B={sh} ({t['launches']} path "
              f"launches): {t['ms'] * 1e3:.2f} us per call through the "
              f"wrapper, {t['kernel_only_ms'] * 1e3:.2f} us per bare launch,"
              f" plain version {t['plain_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']} B at 3.35 TB/s)")
    top = by_shape[0]
    kern = {
        "name": "step_commit", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lockstep_step.cu",
        "replaces": "src/repro/kernels/lockstep_step.py:67",
        "launches": sum(s["launches"] for s in sweeps),
        "max_abs_err": worst_err,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "kernel_only_ms": top["kernel_only_ms"],
        "timed_shape": top["shape"],
        "launches_by_sweep": {s["sweep"]: s["launches"] for s in sweeps},
        "by_shape": by_shape,
    }

    # 6. where a warm sweep's time goes on the card
    prof = profile_sweep(torch, Explorer, ch_tr, ch_rep, ch_a9, ch_cands,
                         libs[("cholesky512_48_cold", "torch")], ls)
    phase("profile", json.dumps({"sweep": "cholesky512_48_warm", **prof}))
    phase("throughput", "; ".join(
        f"{s['sweep']}: torch {s['torch_cand_per_s']:.1f} cand/s "
        f"({s['launches_per_s']:.0f} steps/s), batch "
        f"{s['batch_cand_per_s']:.1f} cand/s" for s in sweeps))
    print(json.dumps({"kernels": [kern]}))
    print(power_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
