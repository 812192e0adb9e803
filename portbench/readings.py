#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the control's.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

One process sets the cell up once (its set-up does not depend on the
seed), then per seed offers the cell's load for a short window of
``--seconds`` (every answer begun in it runs to its end) and judges the
answers twice: as the program gave them, and with the control put in the
program's place (the reference computed in float32, one precision below
the float64 the configuration states).  One JSON line per seed, then a
summary line: the program's largest reading of each number (the lower
reading) and the control's smallest (the upper).  It needs the card, as
a run does; the benchmark's runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import numpy as np
    from portbench import harness, registry
    from portbench.reference.compare import control_answers, judge
    from portbench.reference.sim import Reference, reference_f32
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = registry.cell(args.workload)
    ctx = harness.context(cell, seeds[0], "cuda")
    drv = registry.driver(ctx.traffic)
    drv.setup(ctx)
    ref, ref32 = Reference(ctx.inputs), reference_f32(ctx.inputs)
    rtol = ctx.config["makespan_rtol"]
    lows, highs = {}, {}
    try:
        for seed in seeds:
            ctx.rng = np.random.default_rng(harness.seed_sequence(seed))
            answers = drv.window(ctx, args.seconds, time.perf_counter())
            prog = judge(answers, ref, rtol)
            ctl = judge(control_answers(answers, ref32), ref, rtol)
            for k, v in prog.items():
                lows[k] = max(lows.get(k, v), v)
            for k, v in ctl.items():
                highs[k] = min(highs.get(k, v), v)
            print(json.dumps({"seed": seed, "answers": len(answers),
                              "failed": sum(1 for a in answers
                                            if not a["ok"]),
                              "program": prog, "control": ctl}), flush=True)
    finally:
        drv.close(ctx)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "program_max": lows, "control_min": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
