#!/usr/bin/env python3
"""Copies of the sub-chunked linear-attention source, in turns, on one card.

Builds each given copy of ``linear_attn_tc.cu`` (this checkout's is
``src/repro_torch/kernels/csrc/linear_attn_tc.cu``), and with ``--cuts``
this checkout's source cut at each of its phase boundaries
(``-DLINEAR_ATTN_CUT=n``, n = 1..8: the ``PHASE_CUT`` marks of the
source, 1-6 in the output kernel, 7-8 in the state kernel), all started
together.  It holds each uncut build's output and final state to the plain
version
at the RWKV6 serve path's shape ((BH, T, dk, dv) = (32, 512, 64, 64),
chunk 64, bf16 r/k/v/u, f32 w: ``chip_smoke``'s ``path`` case) at
``chip_smoke``'s tolerances, then times one launch of each, the sources
in turns and then in reverse (A, B, ..., B, A): the device time behind a
device spin (``chip_smoke.queued_us``) and from ``torch.profiler``'s
kernel rows by kernel (``chip_smoke.device_us``; the rows of kernels that
overlap, as programmatic dependent launch lets them, add up to more than
the time behind the spin).  Two versions are compared only within one run:
the card's clock differs between machines.  A cut build's rows, against
the uncut build's, give its kernel's phases' costs.

Run: ``python3 tools/linear_attn_ab.py [--cuts] [A.cu B.cu ...]`` (needs
a card and ``nvcc``).  The last line is one JSON object with every pass.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def compile_source(out_dir: Path, index: int, src: Path,
                   cut: int = 0) -> Path:
    """``src`` (a copy of ``linear_attn_tc.cu``) built by ``nvcc`` with the
    port's flags into ``out_dir``, cut at ``PHASE_CUT(cut)`` (0: uncut)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    out = out_dir / f"linear_attn_tc_{index}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                           f"-DLINEAR_ATTN_CUT={cut}", "-o", str(out),
                           str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


def compile_all(out_dir: Path, sources) -> list:
    """Every ``(source, cut)`` of ``sources`` built, all started
    together."""
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(
            lambda item: compile_source(out_dir, item[0], *item[1]),
            enumerate(sources)))


def bare_launch(torch, la, path: Path, case):
    """A launch of the build at ``path`` at ``case`` (``chip_smoke``'s
    linear case) into fresh outputs, with the packed arguments; returns
    ``(launch, out, state)``, the lambda holding the tensors its raw
    pointers point into."""
    r, k, v, w, u = case["inputs"]
    bh, t, dk, dv = case["shape"]
    lib = la.bind(ctypes.CDLL(str(path)), "linear_attn_tc")
    out = torch.empty_like(v)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device="cuda")
    scratch = torch.empty(la.scratch_floats(lib, bh, t, case["chunk"]),
                          dtype=torch.float32, device="cuda")
    args = la.LINEAR_ARGS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream, bh, t, dk, dv, u.shape[0],
        case["chunk"], *(la.DTYPE_CODES[x.dtype] for x in (r, w, u)))
    launch = (lambda held=(out, state, scratch):
              lib.linear_attn_tc_launch(args))
    if launch() != 0:
        raise SystemExit(f"{path}: the launch failed")
    torch.cuda.synchronize()
    return launch, out, state


def device_times(torch, cs, launch) -> dict:
    """One launch's device time behind a device spin and from the
    profiler's rows, by kernel."""
    queued, enqueue, spin = cs.queued_us(torch, launch)
    dev, rows = cs.device_us(torch, launch)
    by_kernel = {row[0].split("::")[-1].split("<")[0].split("(")[0]:
                 row[2] / max(row[1], 1) for row in rows}
    return {"queued_us": queued, "enqueue_us": enqueue, "spin_us": spin,
            "device_us": dev, "by_kernel_us": by_kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--cuts", action="store_true",
                        help="also this checkout's source cut at each "
                             "phase boundary")
    opts = parser.parse_args()
    if not opts.sources and not opts.cuts:
        parser.error("give sources, --cuts or both")
    import torch
    if not torch.cuda.is_available():
        print("linear_attn_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import linear_attn as la
    from repro_torch.kernels import ops, ref

    cs.phase("card", cs.card_line())
    case = cs.linear_cases(torch, np, la, ops)[0]
    want, want_state = ref.linear_attention_state(*case["inputs"])
    builds = {str(p): (p, 0) for p in opts.sources}
    if opts.cuts:
        own = build.CSRC / la.SOURCE_TC
        builds.update({f"cut {n}": (own, n) for n in range(1, 9)})
        builds.setdefault("uncut", (own, 0))
    names = list(builds)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in zip(names, compile_all(Path(tmp),
                                                 builds.values())):
            launch, out, state = bare_launch(torch, la, path, case)
            launches[name] = launch
            if builds[name][1]:
                continue            # a cut build's output is not whole
            err = float((out.float() - want.float()).abs().max())
            serr = float((state - want_state).abs().max())
            ok = (bool(torch.allclose(out.float(), want.float(),
                                      rtol=case["tol"], atol=case["tol"]))
                  and bool(torch.allclose(state, want_state,
                                          rtol=case["state_tol"],
                                          atol=case["state_tol"])))
            cs.phase("linear ab", f"{name}: max_abs_err={err}, final state "
                     f"{serr}: {ok}")
            if not ok:
                raise SystemExit(f"{name} disagrees with the plain version")
    passes = []
    for name in names + names[::-1]:
        row = {"source": name, **device_times(torch, cs, launches[name])}
        passes.append(row)
        cs.phase("linear ab", f"{name}: {row['queued_us']} us behind the "
                 f"spin (enqueue {row['enqueue_us']:.0f} of "
                 f"{row['spin_us']:.0f} us), rows "
                 f"{json.dumps(row['by_kernel_us'])}")
    print(json.dumps({"shape": case["shape"], "chunk": case["chunk"],
                      "passes": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
