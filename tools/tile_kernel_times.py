#!/usr/bin/env python3
"""The paper's tile kernels (``csrc/tiles.cu``) alone, on one CUDA card.

Runs ``chip_smoke.py``'s tile phase without the rest of the smoke:

* builds ``tiles.cu`` at ``TILE`` 64 and 128 (cached, both started
  together) and prints each build's ``-Xptxas -v`` summary;
* one fresh build at each ``TILE`` (``build.fresh``, as the Fig. 6
  traditional flow makes each candidate's accelerator): its seconds and
  registers, static shared memory and spills;
* every tile case of the paths (``chip_smoke.tile_cases``) held to its
  plain version at its tolerance (``check_tiles``);
* each case timed as ``chip_smoke.time_tiles`` times it: wrapper call,
  bare launch and library call by CUDA events in turns, the plain
  version, and the device time of one bare launch and one library call
  behind a device spin and from ``torch.profiler``'s kernel rows.

Run: ``python3 tools/tile_kernel_times.py`` (needs a card).  The last
line is one JSON object with the builds and the rows.
"""
from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tile_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import build
    from repro_torch.kernels import cholesky_tiles as ct
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase("card", f"{cs.card_line()} | torch {torch.__version__} CUDA "
             f"{torch.version.cuda}")
    defines = (None, {"TILE": 128})
    with ThreadPoolExecutor(len(defines)) as pool:
        libs = list(pool.map(lambda d: build.load(bm.SOURCE, d), defines))
    builds = {}
    for d in defines:
        info = build.BUILD_INFO[build.label(bm.SOURCE, d)]
        builds[build.label(bm.SOURCE, d)] = {
            "seconds": info["seconds"],
            "ptxas": cs.ptxas_summary(info["ptxas"])}
    for tile in (64, 128):
        t0 = time.perf_counter()
        with build.fresh(bm.SOURCE, {"TILE": tile}) as fresh:
            seconds = time.perf_counter() - t0
            edge = fresh.lib.tiles_tile_edge()
            summary = cs.ptxas_summary(fresh.ptxas)
        builds[f"fresh TILE={tile}"] = {"seconds": seconds,
                                        "ptxas": summary}
        if edge != tile:
            raise SystemExit(f"fresh TILE={tile} build reports {edge}")
    for name, b in builds.items():
        cs.phase("build", f"{name}: nvcc {b['seconds']:.2f} s; {b['ptxas']}")
    cases = cs.tile_cases(torch, np, ref, bm, ct, bm.tiles_library(libs[1]))
    errs = cs.check_tiles(torch, cases)
    rows = cs.time_tiles(torch, cases, errs)
    print(json.dumps({"builds": builds, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
