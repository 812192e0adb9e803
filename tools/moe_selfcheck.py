#!/usr/bin/env python3
"""Why a teacher-forced forward is another function than MoE serving:
the (token, choice) pairs each MoE group's capacity drops, and the
self-check's gap under each way of feeding the served sequence back.

Serves mixtral-8x22b cut to 4 of its 56 layers (as ``chip_smoke.py``
does: published widths, bf16, ``torch.Generator`` seed 0, ``SERVE``'s
traffic) on one CUDA card, then prints one JSON line each:

* the served prefills' dropped (token, choice) pairs out of all of them,
  and, for the first prompt's layers, the busiest expert's load against
  the capacity;
* the worst gap of a served token below its position's maximum, and how
  many served tokens are the argmax, when the served sequence is fed back
  through: ``forward`` (groups of 181 of the 543 tokens, capacity 57), the
  same with no capacity limit (capacity factor E / top_k), ``forward``
  with one group of all 543 tokens, and the incremental recomputation
  ``chip_smoke.py`` gates (each prompt prefilled alone, then batch-1
  decode steps) — with the drops each made.

Run: ``python3 tools/moe_selfcheck.py`` (needs a card).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class DropCount:
    """Installed as the transformer module's ``moe_apply``: counts the
    (token, choice) pairs past their expert's capacity, as ``moe_apply``
    drops them, and each call's busiest expert against the capacity."""

    def __init__(self, T, moe):
        self.T, self.moe = T, moe
        self.dropped = self.choices = 0
        self.loads = []

    def __call__(self, p, x, *, top_k, capacity_factor, group_size,
                 dispatch):
        import torch
        M = self.moe
        b, t, d = x.shape
        e = p.router.w.shape[1]
        gs = M.snap_group_size(b * t, group_size)
        probs = torch.softmax(x.reshape(-1, gs, d).float() @ p.router.w,
                              dim=-1)
        idx = M.top_k_stable(probs, top_k)[1]
        cap = M.capacity_of(gs, top_k, e, capacity_factor)
        load = M.one_hot(idx, e).sum(dim=(1, 2))             # (G, E)
        self.dropped += int((load - cap).clamp(min=0).sum())
        self.choices += idx.numel()
        self.loads.append({"busiest": float(load.max()), "capacity": cap,
                           "group": gs})
        return M.moe_apply(p, x, top_k=top_k,
                           capacity_factor=capacity_factor,
                           group_size=group_size, dispatch=dispatch)

    def __enter__(self):
        self.T.moe_apply = self
        return self

    def __exit__(self, *exc):
        self.T.moe_apply = self.moe.moe_apply


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_selfcheck: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from chip_smoke import MIXTRAL_LAYERS, SERVE, teacher_forced
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("mixtral-8x22b"),
                              n_layers=MIXTRAL_LAYERS)
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(SERVE["prompt_len"],),
                            dtype=np.int32) for _ in range(SERVE["requests"])]
    max_len = SERVE["prompt_len"] + SERVE["max_new"] + 1
    eng = engine.Engine(model, slots=SERVE["slots"], max_len=max_len)
    for rid, pr in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=pr,
                                  max_new=SERVE["max_new"]))
    done = eng.run()

    with DropCount(T, moe) as count:
        for pr in prompts:
            T.prefill(model, {"tokens": torch.as_tensor(
                pr, device="cuda")[None]}, max_len)
    print(json.dumps({"served_prefills": {
        "dropped": count.dropped, "choices": count.choices,
        "first_prompt_layers": count.loads[:MIXTRAL_LAYERS]}}), flush=True)

    def variant(**kw):
        m = T.Transformer(dataclasses.replace(cfg, **kw), device="meta")
        m.load_state_dict(model.state_dict(), assign=True)
        return m

    fed_back = (
        ("forward", model, False),
        ("forward, no capacity limit",
         variant(capacity_factor=cfg.n_experts / cfg.top_k), False),
        ("forward, one group", variant(moe_group_size=2 * max_len), False),
        ("incremental (prefill alone, batch-1 decode)", model, True))
    for label, m, incremental in fed_back:
        with DropCount(T, moe) as count:
            worst, exact = teacher_forced(torch, np, T, m, done, max_len,
                                          incremental=incremental)
        print(json.dumps({"fed_back": label, "worst_gap": worst,
                          "argmax_equal": exact,
                          "served": sum(len(r.out) for r in done),
                          "dropped": count.dropped,
                          "choices": count.choices}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
