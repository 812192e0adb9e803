#!/usr/bin/env python3
"""How often the sub-chunked linear-attention kernel's roundings flip the
bf16 output, on the CPU.

Runs the plain mirror of ``csrc/linear_attn_tc.cu``'s arithmetic
(``subchunk_mirror``, which lives with the tests that hold it to the JAX
package, ``tests/test_torch_linear_attn.py``) at the RWKV6 serve path's
shape, (BH, T, dk, dv) = (32, 512, 64, 64), chunk 64, on
``chip_smoke.py``'s ``path`` inputs (``linear_inputs`` at seed 20, on
the CPU: bf16 r/k/v/u, f32 w), under
each rounding of the products' operands, and counts the outputs whose
bf16 value differs from the exact recurrence's (in f64, then rounded to
bf16):

* ``f32``: every product in f32 (the f32 route);
* ``split`` / ``split``: two bf16 terms for every operand;
* ``split`` / ``split3``: two terms, three for the scores in scores.v
  (the bf16 route);
* ``bf16`` / ``bf16``: one rounding for every operand.

Also the final state's largest difference from the recurrence's.  Run:
``python3 tools/linear_attn_rounding.py`` (CPU, ~10 s).  The last line is
one JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = (("f32", "f32"), ("split", "split"), ("split", "split3"),
            ("bf16", "bf16"))


def main() -> int:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from test_torch_linear_attn import subchunk_mirror
    inputs = cs.linear_inputs(torch, np, 20, cs.LINEAR_PATH, "bfloat16",
                              device="cpu")
    exact, exact_state = ref.linear_attention_state(
        *(x.double() for x in inputs))
    want = exact.to(torch.bfloat16)
    rows = {}
    for rounding, pv_rounding in VARIANTS:
        got, state = subchunk_mirror(*inputs, cs.LINEAR_CHUNK, rounding,
                                     pv_rounding)
        name = f"{rounding}/{pv_rounding}"
        rows[name] = {"flips": int((got != want).sum()),
                      "state_max_abs_diff": float(
                          (state.double() - exact_state).abs().max())}
        print(f"{name}: {rows[name]['flips']} of {want.numel()} bf16 "
              f"outputs differ from the exact recurrence's; final state "
              f"within {rows[name]['state_max_abs_diff']:.3g}", flush=True)
    print(json.dumps({"shape": [32, 512, 64, 64], "chunk": 64,
                      "outputs": want.numel(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
