#!/usr/bin/env python3
"""The sweep service's torch requests: one engine at a time, or interleaved.

Sends ``--requests`` torch requests of ``chip_smoke.py``'s (b) body (the
Cholesky trace at n = 512, bs = 64, inline, ``accs "1-8"``: 16
candidates) to an in-process ``repro_torch.serve.sweepd.SweepService``
from as many threads at once, once for each mode:

* ``N`` (a number): the service as it is, with ``max_concurrent = N``:
  up to N requests are admitted at once and the rest queue, and torch
  sweeps take the engine one at a time (the service's engine lock);
* ``N-interleaved``: the same with the engine lock taken out, so up to N
  torch sweeps run in threads of the process at once, interleaving their
  step loops' launches.

Each mode gets a fresh service and one warm-up request first (not
counted), so the kernel build, the CUDA context and the first graph are
paid outside the window.  The sweeps run the step loop as replays of
captured CUDA graphs (the process-wide compile cache of
``repro_torch.core.torchsim``, captured by the first warm-up): requests
share a runner of one shape signature, one at a time (its lock).  A mode's line gives its wall, candidates per
second, each request's ``sweep_s`` and ``queue_s`` and the step-commit
launches in the window; every answer must be a 200 with the same best.

Run: ``python3 tools/sweepd_concurrency.py [--device cuda] [--requests 8]
[--modes 1,4,4-interleaved]`` (the card by default).  The last line is one
JSON object with every mode.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class NoLock:
    """A lock that never makes anyone wait."""

    def acquire(self, timeout: float = -1) -> bool:
        return True

    def release(self) -> None:
        pass


def run_mode(mode: str, device: str, requests: int, body: dict) -> dict:
    from repro_torch.kernels import lockstep_step as ls
    from repro_torch.serve.sweepd import SweepService

    width = int(mode.split("-")[0])
    svc = SweepService(device=device, max_concurrent=width)
    raw = json.dumps(body)
    warm_status, warm = svc.submit(raw)
    if warm_status != 200:
        raise SystemExit(f"{mode}: warm-up answered {warm_status}: {warm}")
    if mode.endswith("-interleaved"):
        svc._torch_lock = NoLock()
    results = [None] * requests

    def client(i):
        results[i] = svc.submit(raw)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(requests)]
    ls.LAUNCHES = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(s, d.get("error")) for s, d in results
           if s != 200 or d["best"] != warm["best"]]
    if bad:
        raise SystemExit(f"{mode}: failed answers {bad}")
    n = requests * warm["candidates"]
    return {"mode": mode, "max_concurrent": width, "requests": requests,
            "candidates": n, "wall_s": wall, "cand_per_s": n / wall,
            "launches": ls.LAUNCHES, "best": warm["best"],
            "warm_up_sweep_s": warm["timings"]["sweep_s"],
            "sweep_s": [d["timings"]["sweep_s"] for _, d in results],
            "queue_s": [d["timings"]["queue_s"] for _, d in results]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--modes", default="1,4,4-interleaved")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.apps import cholesky as ch

    card = (cs.card_line() if args.device == "cuda" else "cpu")
    body = cs.inline_request(ch.trace_cholesky(n=512, bs=64),
                             ch.report_map(bs=64), "1-8", "torch", 16)
    rows = []
    for mode in args.modes.split(","):
        row = run_mode(mode, args.device, args.requests, body)
        rows.append(row)
        print(f"[{mode}] {row['requests']} requests in {row['wall_s']:.2f}"
              f" s, {row['cand_per_s']:.2f} cand/s, sweep_s "
              f"{min(row['sweep_s']):.2f}-{max(row['sweep_s']):.2f}, "
              f"{row['launches']} launches", flush=True)
    print(json.dumps({"card": card, "modes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
