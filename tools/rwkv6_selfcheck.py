#!/usr/bin/env python3
"""rwkv6-1.6b's serve self-check through each linear-attention route, on
one CUDA card.

Serves ``chip_smoke.py``'s traffic (8 requests of 512-token prompts, 32
new tokens each, 4 slots) with rwkv6-1.6b at full width in bf16 (weights
from a ``torch.Generator`` seeded 0, as the smoke draws them), and runs
``examples/serve_e2e.py``'s self-check as the smoke does: one
teacher-forced ``forward`` per request over its served sequence, and how
far each served token's logit is below its position's maximum.  The
prefills and the forwards take, in turn:

* ``subchunk``: the kernel ``linear_attn.kernel_for`` names at these
  shapes (``csrc/linear_attn_tc.cu``);
* ``serial``: the serial kernel (``csrc/linear_attn.cu``), by a
  ``kernel_for`` that names it for every call (this tool only);
* ``chunked``: no kernel, the plain PyTorch chunked form
  (``attn_impl="chunked"``) on the same weights.

The decode steps take the plain per-token recurrence in every case, as
the engine does.  The spread of the worst gap across the routes is the
noise of the model's bf16 arithmetic that ``chip_smoke.SELFCHECK_TOL``
sits in.

Run: ``python3 tools/rwkv6_selfcheck.py`` (needs a card).  The last line
is one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def selfcheck(torch, np, T, engine, model, prompts, max_new, slots):
    """Serve ``prompts`` and return ``(worst gap, served tokens that are
    the forward's argmax, served tokens)``."""
    max_len = len(prompts[0]) + max_new + 1
    eng = engine.Engine(model, slots=slots, max_len=max_len)
    for rid, pr in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=max_new))
    done = eng.run()
    worst, exact, served = 0.0, 0, 0
    for r in done:
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        logits, _ = T.forward(model, {"tokens": torch.as_tensor(
            seq, device="cuda")[None]})
        pos = logits[0, len(r.prompt) - 1:]
        picked = pos.gather(1, torch.as_tensor(r.out, device="cuda")[:, None])
        gaps = pos.amax(1) - picked[:, 0]
        worst = max(worst, float(gaps.max()))
        exact += int((gaps == 0).sum())
        served += len(r.out)
    return worst, exact, served


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rwkv6_selfcheck: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import linear_attn as la
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase("card", cs.card_line())
    cfg = configs.get_config("rwkv6-1.6b")
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(cs.SERVE["prompt_len"],),
                            dtype=np.int32)
               for _ in range(cs.SERVE["requests"])]
    chunked = T.Transformer(dataclasses.replace(cfg, attn_impl="chunked"),
                            device="meta")
    chunked.load_state_dict(model.state_dict(), assign=True)
    routed = la.kernel_for
    rows = {}
    for route in ("subchunk", "serial", "chunked", "subchunk"):
        la.VARIANTS.clear()
        if route == "serial":
            la.kernel_for = lambda *args: "serial"
        try:
            worst, exact, served = selfcheck(
                torch, np, T, engine, chunked if route == "chunked" else model,
                prompts, cs.SERVE["max_new"], cs.SERVE["slots"])
        finally:
            la.kernel_for = routed
        torch.cuda.synchronize()
        rows.setdefault(route, []).append(
            {"worst_gap": worst, "argmax_equal": exact, "served": served,
             "kernels": dict(la.VARIANTS)})
        cs.phase("rwkv6 self-check", f"{route}: {exact}/{served} served "
                 f"tokens are the forward's argmax, the worst is {worst} "
                 f"below its position's maximum (limit "
                 f"{cs.SELFCHECK_TOL}); linear_attn launches by kernel "
                 f"{dict(la.VARIANTS)}")
    print(json.dumps({"arch": cfg.name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
