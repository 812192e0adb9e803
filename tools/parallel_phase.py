#!/usr/bin/env python3
"""The distribution phases of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.parallel_flow``, ``pipeline_flow`` and ``dryrun_flow``
without the rest of the smoke: [parallel] restores a checkpoint of
qwen3-0.6b's train state as DTensors on a (1, 1) mesh over NCCL and as
plain tensors and holds one AdamW step of each to the other, then
``make_overlapped_matmul`` to ``torch.matmul``; [pipeline] prefills
qwen3-0.6b whole and in 2 stages of 4 microbatches through the flash
kernel; [dryrun] runs the dry-run's cells, each in an interpreter of its
own.  Without the [train] slice's checkpoint (``chip_smoke.SLICE_CKPT``)
it writes one of a freshly drawn state first, and [dryrun] (a) has no
measured peak to be held to (pass ``--peak-bytes`` and ``--step-ms``
from a [train] run to hold it).  Unlike the smoke, a phase that raises is
reported and the next one still runs (the tool exits 1).

Run: ``python3 tools/parallel_phase.py`` (needs a card).  Exits 1 if a
check failed; the last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peak-bytes", type=float, default=None)
    ap.add_argument("--step-ms", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke               # sets CUBLAS_WORKSPACE_CONFIG first
    import torch
    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as S
    torch.backends.cuda.matmul.allow_tf32 = False
    if ckpt.latest_step(chip_smoke.SLICE_CKPT) is None:
        cfg = dataclasses.replace(configs.get_config(chip_smoke.TRAIN_ARCH),
                                  attn_impl="chunked")
        model, state = S.init_train_state(
            cfg, S.TrainConfig(opt=opt_mod.OptConfig()), 0, device="cuda")
        ckpt.save(chip_smoke.SLICE_CKPT, chip_smoke.TRAIN_SLICE["steps"],
                  {"params": model, "opt": state})
        del model, state
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    failures = []
    trained = ({"slice": {"peak_bytes": args.peak_bytes,
                          "step_ms_median": args.step_ms}}
               if args.peak_bytes else None)
    flows = (("parallel", lambda: chip_smoke.parallel_flow(
                 torch, np, configs, T, failures)),
             ("pipeline", lambda: chip_smoke.pipeline_flow(
                 torch, np, configs, T, fa, failures)),
             ("dryrun", lambda: chip_smoke.dryrun_flow(
                 torch, trained, failures)))
    for name, flow in flows:
        try:               # a tool: report a phase's error, run the next
            flow()
        except Exception:  # noqa: BLE001 — printed and counted as failed
            failures.append(f"{name}: {traceback.format_exc()[-3000:]}")
    for f in failures:
        print(f"parallel_phase: FAILED: {f}", file=sys.stderr)
    print(chip_smoke.card_line())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
