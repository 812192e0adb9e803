#!/usr/bin/env python3
"""Where ``trsm_tile_kernel``'s device time goes, on one CUDA card.

Builds copies of ``src/repro_torch/kernels/csrc/tiles.cu`` into a
temporary directory, each cut short at one phase boundary of
``trsm_tile_kernel`` (the PTX ``exit`` instruction put in front of the
named line, as inline assembly: the compiler cannot see that the block
ends there, so it keeps the phases before the cut, whose results a
``return`` would leave dead and let it delete), and times one launch of
each at the Cholesky path's shape, (bs, n) =
(64, 64) f32 with panel 16, plus the uncut kernel:

* ``launch``: returns before staging (the launch and an empty block);
* ``staged``: after A and the block's B columns are in shared memory;
* ``reciprocals``: after the reciprocals of A's diagonal;
* ``inverted``: after the diagonal panels' inverses;
* ``full``: the kernel as built for the paths.

Each is timed by ``chip_smoke.queued_us`` (CUDA events around 20 launches
behind a device spin) and ``chip_smoke.device_us`` (``torch.profiler``'s
kernel rows); the differences between rows are the phases' costs.  Only
the uncut kernel's output is held to the plain version.

Run: ``python3 tools/trsm_phase_times.py`` (needs a card and ``nvcc``).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Variant name -> the line in front of which ``exit`` goes (None: the
#: uncut kernel).
CUTS = {
    "launch": "  stage(As, bs, a, bs, bs, bs, bs, bs, vec_mask & 1, tid, "
              "kTrsmThreads);",
    "staged": "  // each of the diagonal's reciprocals once",
    "reciprocals": "  // The diagonal panels' inverses, all at once",
    "inverted": "  // Each thread of the two steps takes one row",
    "full": None,
}


def variant(text: str, marker: str) -> str:
    """``text`` with the block's ``exit`` in front of ``marker`` inside
    ``trsm_tile_kernel`` (the marker must occur exactly once)."""
    if text.count(marker) != 1:
        raise SystemExit(f"marker not found once in tiles.cu: {marker!r}")
    return text.replace(marker, '  asm volatile("exit;");\n' + marker)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("trsm_phase_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import build, ref

    cs.phase("card", cs.card_line())
    text = (build.CSRC / bm.SOURCE).read_text()
    bs, n, panel = 64, 64, 16
    up = cs.upper_tile(torch, np, 4, bs)
    (rhs,) = cs.tile_inputs(torch, np, 5, (bs, n))
    out = torch.empty_like(rhs)
    stream = torch.cuda.current_stream().cuda_stream
    args = bm.TRSM_ARGS.pack(up.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                             stream, bs, n, panel, 0)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, marker in CUTS.items():
            src = Path(tmp) / f"tiles_{name}.cu"
            src.write_text(text if marker is None else variant(text, marker))
            lib_path = Path(tmp) / f"tiles_{name}.so"
            proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                                   "-o", str(lib_path), str(src)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
            lib = bm.bind(ctypes.CDLL(str(lib_path)))
            launch = lambda lib=lib: lib.tiles_trsm_launch(args)  # noqa: E731
            if launch() != 0:
                raise SystemExit(f"{name}: the launch failed")
            torch.cuda.synchronize()
            if marker is None:
                err = float((out - ref.trsm(up, rhs)).abs().max())
                if err > cs.TRSM_TOL:
                    raise SystemExit(f"full kernel: max_abs_err {err}")
            queued, enqueue, spin = cs.queued_us(torch, launch)
            dev, kernel_rows = cs.device_us(torch, launch)
            rows[name] = {"queued_us": queued, "device_us": dev,
                          "enqueue_us": enqueue, "spin_us": spin}
            cs.phase("trsm phase", f"{name}: {queued} us behind the spin "
                     f"(enqueue {enqueue:.0f} of {spin:.0f} us), {dev} us "
                     f"on the profiler's rows {json.dumps(kernel_rows)}")
    print(json.dumps({"shape": [bs, n], "panel": panel, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
