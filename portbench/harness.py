"""One run of one cell: set up, measure a window, check, and report.

The steps, in order: the configuration's inputs are generated; the
traffic's driver builds the program's side and warms up every shape the
window uses (set-up ends here); the window offers the load for
``--seconds`` and runs what began inside it to its end; the device's peak
memory is read and the program's side is closed; the reference judges
every answer; the metrics are read.  With ``--trace 1`` host spans and
CUDA events around the step loop's slices are taken for the window, and
after it the device is profiled over a slice of the same load
(:func:`_device_tail`): the profiler's callbacks slow the host, so no
metric of the window is read from that slice but the kernels' names and
device times.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional

import numpy as np

from portbench import apps, devtrace, port, registry
from portbench.reference.compare import judge, verdict
from portbench.reference.sim import Reference
from portbench.spans import Spans

#: Top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where there
    is none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative or past 64 bits, as a NumPy seed."""
    return np.random.SeedSequence(int(seed) % (1 << 128))


def context(cell: Mapping, seed: int, device: str) -> SimpleNamespace:
    import torch
    on_card = device == "cuda"
    return SimpleNamespace(
        cell=cell, config=cell["config"], traffic=cell["traffic"],
        inputs=apps.inputs(cell["config"]), seed=seed, device=device,
        rng=np.random.default_rng(seed_sequence(seed)),
        synchronize=torch.cuda.synchronize if on_card else (lambda: None))


def _load(drv, ctx, seconds: float):
    """The driver's load from now for ``seconds``, in a thread of its
    own; returns ``(thread, t0, box)``, the answers in ``box``."""
    box: Dict = {}
    t0 = time.perf_counter()

    def load() -> None:
        try:
            box["answers"] = drv.window(ctx, seconds, t0)
        except BaseException as exc:    # noqa: BLE001 — re-raised on join
            box["error"] = exc

    th = threading.Thread(target=load, name="portbench-load")
    th.start()
    return th, t0, box


def _joined(th, box) -> List[Dict]:
    th.join()
    if "error" in box:
        raise box["error"]
    return box["answers"]


def _window(drv, ctx, seconds: float) -> Dict:
    """The measured window, with the port's counters across it."""
    before = port.counters()
    th, _, box = _load(drv, ctx, seconds)
    answers = _joined(th, box)
    ctx.synchronize()
    return {"answers": answers,
            "counters": port.counters_delta(before, port.counters())}


def _device_tail(drv, ctx, spans: Spans) -> Optional[Dict]:
    """With ``--trace 1``, after the window: the same load again for the
    traffic's ``trace_at + trace_seconds``, the device profiled over its
    slice ``[trace_at, trace_at + trace_seconds]``.  The profiler is
    started once beforehand (its first start initialises CUPTI, some
    seconds) and is started and stopped under the spans' gate.  The
    window's own spans and counters are untouched by it; its answers are
    judged with the window's."""
    t = ctx.traffic
    devtrace.warm()
    th, t0, box = _load(drv, ctx, t["trace_at"] + t["trace_seconds"])
    time.sleep(max(0.0, t0 + t["trace_at"] - time.perf_counter()))
    with spans.gate:
        handle = devtrace.start()
    time.sleep(t["trace_seconds"])
    with spans.gate:
        raw = devtrace.stop(handle)
    answers = _joined(th, box)
    ctx.synchronize()
    dev = devtrace.reduce(*raw)
    if dev is not None:
        print(f"portbench: traced {dev['window_s']:.3f} s, "
              f"{dev['events']} device events, the last ending "
              f"{dev['covered_s']:.3f} s in, clocks aligned "
              f"{dev['aligned']}", file=sys.stderr)
    return {"answers": answers, "devtrace": dev}


def end_to_end(run: Mapping, names: List[str]) -> Dict[str, float]:
    """``cand_per_s``: candidates ranked in answered sweeps over the wall
    from the window's start to the end of the last sweep begun in it;
    ``setup_s``."""
    ans = run["answers"]
    wall = max(a["t1"] for a in ans)
    out = {"cand_per_s": sum(len(a["expected"]) for a in ans if a["ok"])
           / wall,
           "setup_s": run["setup_s"]}
    return {k: out[k] for k in names}


def run_cell(cell: Mapping, seed: int, seconds: float, trace: bool,
             device: str, process_start: float) -> Dict:
    """One run of ``cell``; returns the result's fields (the caller
    checks ``sys.modules`` and prints).  ``process_start`` is the
    ``perf_counter`` at which the process was ``process_age`` old."""
    import torch
    ctx = context(cell, seed, device)
    drv = registry.driver(ctx.traffic)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv.setup(ctx)
    ctx.synchronize()
    spans = Spans(device).install() if trace else None
    tail = None
    try:
        setup_s = time.perf_counter() - process_start
        run = _window(drv, ctx, seconds)
        run["spans"] = spans.snapshot() if trace else None
        if trace and device == "cuda":
            tail = _device_tail(drv, ctx, spans)
    finally:
        if spans is not None:
            spans.remove()
    run["setup_s"] = setup_s
    run["devtrace"] = tail["devtrace"] if tail else None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    drv.close(ctx)

    answers = run["answers"]
    judged = answers + (tail["answers"] if tail else [])
    conf = ctx.config
    numbers = judge(judged, Reference(ctx.inputs), conf["makespan_rtol"])
    limits = conf["limits"]
    correct = verdict(numbers, limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = registry.reader(m).read(run)
            if v is not None:
                metrics[m] = {"value": v, "unit": cell["per_layer_units"][m]}
    else:
        metrics = {k: {"value": v, "unit": cell["end_to_end_units"][k]}
                   for k, v in end_to_end(run, cell["end_to_end"]).items()}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": name, "count": cell["chips"] if device == "cuda" else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(answers),
              "failed": sum(1 for a in answers if not a["ok"]),
              "metrics": metrics, "device": dev}
    if trace:
        dt = run["devtrace"]
        dev["busy_s"] = dt["busy_s"] if dt else 0.0
        dev["window_s"] = dt["window_s"] if dt else 0.0
        if dt:
            ops = sorted(dt["ops"].items(), key=lambda kv: -kv[1][1])[:10]
            result["breakdown"] = {
                "device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": devtrace.label_gaps(dt, spans)}
    result["checks"] = checks
    return result
