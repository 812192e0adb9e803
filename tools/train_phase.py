#!/usr/bin/env python3
"""The train phase of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.train_flow`` without the rest of the smoke: qwen3-0.6b
at its published width on the chunked route, (a) one step on the card
against the same step on the CPU (2 layers, f32), (b) the three remat
modes and accumulation, (c) the supervisor's replay under deterministic
algorithms, (d) the full depth in bf16 through the supervisor (tokens/s,
ms a step, peak memory, a 3-step profile, the loss falling), (e) the
kernel wrappers' refusal of operands that require grad.  No kernel is
built: the train step launches none.

Run: ``python3 tools/train_phase.py`` (needs a card).  Exits 1 if a check
failed; the last line is the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke               # sets CUBLAS_WORKSPACE_CONFIG first
    import torch
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    chip_smoke.train_flow(torch, np, configs, T, failures)
    for f in failures:
        print(f"train_phase: FAILED: {f}", file=sys.stderr)
    print(chip_smoke.card_line())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
