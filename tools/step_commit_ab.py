#!/usr/bin/env python3
"""step_commit of two source trees, in turns, on one CUDA card.

Times the step-commit kernel of this checkout against that of another
checkout of the port (an earlier commit unpacked with ``git archive``),
each side in its own process that imports its own ``repro_torch``, in
the order other, this, this, other.  At each ``(P, S, B)`` a side:

* holds one launch to ``step_commit_ref`` bit for bit on a seeded state
  (``chip_smoke.seeded_state``: ties, all-``inf`` pools, dead lanes) and
  exits if they differ;
* times its wrapper call and its bare launch (no checks, no allocation)
  by CUDA events, two passes in turns;
* reads the device time of one bare launch behind a device spin
  (``chip_smoke.queued_us``) and from ``torch.profiler``'s kernel rows
  (``chip_smoke.device_us``).

Both sides use this checkout's timing helpers.  A side's bare launch takes
the entry its source has: one packed argument block where the wrapper
module has ``STEP_ARGS``, else the eleven positional arguments of the
first design.

Run: ``python3 tools/step_commit_ab.py --other DIR [--shape P,S,B ...]``
(needs a card).  The last line is one JSON object with every pass.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: The sweeps' commonest launch first (43,008 of 86,648 launches on the
#: four sweeps of ``chip_smoke.py``), then its other check shapes.
DEFAULT_SHAPES = ((4, 128, 16), (2, 64, 256), (4, 16, 256), (3, 5, 128))


def side(shapes) -> dict:
    """One side's rows, measured with the ``repro_torch`` first on the
    path."""
    import numpy as np
    import torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import lockstep_step as ls

    rows = []
    for P, S, B in shapes:
        rng = np.random.default_rng(1)
        host = [torch.from_numpy(a) for a in cs.seeded_state(rng, P, S, B)]
        dev = [t.clone().cuda() for t in host]
        ref = [t.clone().cuda() for t in host]
        end = torch.empty(B, dtype=torch.float64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in dev] + [end.data_ptr()]
        if hasattr(ls, "STEP_ARGS"):
            lib = ls.step_library()
            args = ls.STEP_ARGS.pack(*ptrs, stream, S, B)

            def bare(lib=lib, args=args):
                return lib.step_commit_launch(args)
        else:
            lib = ls._lib()

            def bare(lib=lib, ptrs=ptrs, S=S, B=B):
                return lib.step_commit_launch(*ptrs, S, B, stream)
        if bare() != 0:
            raise SystemExit(f"bare step_commit launch failed at {P, S, B}")
        want = ls.step_commit_ref(*ref)
        torch.cuda.synchronize()
        same = all(cs.compare(x, y)[0] for x, y in
                   zip(dev[:3] + [end], ref[:3] + [want]))
        if not same:
            raise SystemExit(f"step_commit differs from step_commit_ref at "
                             f"{P, S, B}")
        runs = {"wrapper": lambda: ls.step_commit(*dev), "bare": bare}
        ev = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            ev[name].append(cs.time_ms(runs[name], 2000))
        us, kernel_rows = cs.device_us(torch, bare)
        q_us, enqueue, spin = cs.queued_us(torch, bare)
        rows.append({"shape": [P, S, B],
                     "wrapper_us": sum(ev["wrapper"]) / 2 * 1e3,
                     "bare_us": sum(ev["bare"]) / 2 * 1e3,
                     "event_ms_by_pass": ev, "queued_us": q_us,
                     "queued_enqueue_us": enqueue, "queued_spin_us": spin,
                     "device_us": us, "device_kernels": kernel_rows})
    return {"source": str(Path(ls.__file__).resolve()), "rows": rows}


def run_side(src: Path, shapes) -> dict:
    """:func:`side` in a fresh process with ``src`` first on the path."""
    env = dict(os.environ, PYTHONPATH=str(src))
    arg = ";".join(",".join(map(str, sh)) for sh in shapes)
    out = subprocess.run([sys.executable, __file__, "--side", arg],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"side {src} failed:\n{out.stdout}{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path,
                        help="root of the other checkout")
    parser.add_argument("--shape", action="append", default=[],
                        help="P,S,B (repeatable)")
    parser.add_argument("--side", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.side:
        shapes = [tuple(int(x) for x in sh.split(","))
                  for sh in opts.side.split(";")]
        print(json.dumps(side(shapes)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("step_commit_ab: no CUDA device", file=sys.stderr)
        return 1
    if opts.other is None:
        parser.error("--other is required")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    shapes = ([tuple(int(x) for x in sh.split(",")) for sh in opts.shape]
              or list(DEFAULT_SHAPES))
    cs.phase("card", cs.card_line())
    srcs = {"other": opts.other.resolve() / "src", "this": ROOT / "src"}
    passes = []
    for name in ("other", "this", "this", "other"):
        result = run_side(srcs[name], shapes)
        passes.append({"side": name, **result})
        for row in result["rows"]:
            q = ("not measured" if row["queued_us"] is None
                 else f"{row['queued_us']:.2f} us")
            d = ("not measured" if row["device_us"] is None
                 else f"{row['device_us']:.2f} us")
            cs.phase(f"step_commit {name}", f"P,S,B={row['shape']}: "
                     f"wrapper {row['wrapper_us']:.2f} us, bare launch "
                     f"{row['bare_us']:.2f} us, device behind a spin {q}, "
                     f"by profiler rows {d}")
    print(json.dumps({"card": cs.card_line(), "passes": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
