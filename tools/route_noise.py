#!/usr/bin/env python3
"""How far an arch's last-position prefill logits move between routes
that compute the same function, at full width on one CUDA card.

Builds ``--arch`` (rwkv6-1.6b by default, zamba2-1.2b, mixtral-8x22b
cut to 4 of its 56 layers as ``chip_smoke.py`` serves it, pixtral-12b or
whisper-tiny; ``--layers`` cuts the depth) at its published widths from
``torch.Generator`` seed 0 (as ``chip_smoke.py`` does), prefills the same
eight prompts ``chip_smoke.py`` serves (512 tokens; whisper's 256 tokens
with their 1500 seeded frames; pixtral's both text-only and behind their
256 seeded patches: ``chip_smoke.fused_requests``), and reports the max
abs difference of the last-position logits between:

* the kernel route (``attn_impl="kernel"``: the linear-attention kernels,
  and the flash kernel for zamba2's shared block and the attention archs)
  and the plain route (``attn_impl="chunked"``; for the attention archs
  also ``"naive"``, the route ``chip_smoke.py`` gates them against), in
  bf16 and in f32 (whisper's encoder and cross-attention run
  ``attention_chunked`` on every route);
* two plain routes: for the recurrent archs the closed form at chunk 64
  and at chunk 32, for the attention archs the naive and chunked
  attention (the same arithmetic summed in another order: the rounding
  noise of the model itself);
* for mixtral, the routing decisions (each token's top-2 experts in each
  layer) that differ between each pair of routes, out of all of them;
* per layer (and per shared site), the hidden state's max abs difference
  between the kernel and chunked routes, in bf16, for the first prompt;
* ``chip_smoke.py``'s self-check (eight requests served through
  ``Engine(slots=4)``, 32 new tokens each, then a teacher-forced forward
  over each served sequence) with the forward through either route
  (not for whisper, which ``Engine.run`` cannot serve: its prefill needs
  frames);

and, for rwkv6-1.6b, the kernel against its plain version at the path
shape with the model's own decays (``w = exp(-exp(-4 + 0.01 z))``, ~0.98
a step).

Run: ``python3 tools/route_noise.py [--arch zamba2-1.2b|mixtral-8x22b|
pixtral-12b|whisper-tiny] [--layers N]`` (needs a card; prints one JSON
line per measurement).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: mixtral-8x22b's depth on one card (``chip_smoke.py``'s MIXTRAL_LAYERS).
MIXTRAL_LAYERS = 4


class RoutingLog:
    """Records each MoE call's top-k experts (``gate_idx``, as
    ``moe_apply`` picks them) while installed as the transformer module's
    ``moe_apply``."""

    def __init__(self, T, moe):
        self.T, self.moe, self.calls = T, moe, []

    def __call__(self, p, x, *, top_k, **kw):
        import torch
        probs = torch.softmax(
            x.reshape(-1, x.shape[-1]).float() @ p.router.w, dim=-1)
        self.calls.append(self.moe.top_k_stable(probs, top_k)[1])
        return self.moe.moe_apply(p, x, top_k=top_k, **kw)

    def __enter__(self):
        self.T.moe_apply = self
        return self

    def __exit__(self, *exc):
        self.T.moe_apply = self.moe.moe_apply


def last_logits(T, model, batches):
    """The last-position prefill logits of each prefill batch, and the
    routing decisions the prefills made (one tensor of top-k experts per
    MoE call, in call order; none for a model without MoE layers)."""
    import torch
    from chip_smoke import positions
    from repro_torch.models import moe
    out = []
    with RoutingLog(T, moe) as log:
        for batch in batches:
            logits, _ = T.prefill(model, batch, positions(batch) + 1)
            out.append(logits[0, -1].float())
    return torch.stack(out), log.calls


def routes(T, cfg, state, batches, pairs):
    """Max abs difference of the last-position logits for each pair of
    ``(attn_impl, scan_chunk)`` settings, on the same weights, and for an
    MoE arch the routing decisions that differ (and their total)."""
    logits, picks = {}, {}
    for setting in {s for pair in pairs for s in pair}:
        impl, chunk = setting
        m = T.Transformer(dataclasses.replace(cfg, attn_impl=impl,
                                              scan_chunk=chunk),
                          device="meta")
        m.load_state_dict(state, assign=True)
        logits[setting], picks[setting] = last_logits(T, m, batches)
    name = lambda a, b: f"{a[0]}{a[1]} vs {b[0]}{b[1]}"
    diffs = {name(a, b): float((logits[a] - logits[b]).abs().max())
             for a, b in pairs}
    routing = {name(a, b): [sum(int((x != y).sum()) for x, y in
                                zip(picks[a], picks[b])),
                            sum(int(x.numel()) for x in picks[a])]
               for a, b in pairs if picks[a]}
    return diffs, float(max(v.abs().max() for v in logits.values())), \
        routing


def layer_divergence(T, cfg, state, batch):
    """Per layer and shared site, in the order the stack applies them, the
    max abs difference of the hidden state after it between the kernel
    and chunked routes, and its max magnitude, over the prefill
    ``batch``."""
    import torch
    hidden = {}
    for impl in ("kernel", "chunked"):
        m = T.Transformer(dataclasses.replace(cfg, attn_impl=impl),
                          device="meta")
        m.load_state_dict(state, assign=True)
        outs = []
        blocks = list(m.layers) + ([m.shared] if m.shared is not None
                                   else [])
        hooks = [b.register_forward_hook(
            lambda mod, args, out: outs.append(out[0].float()))
            for b in blocks]
        T.forward(m, batch)
        for h in hooks:
            h.remove()
        hidden[impl] = outs
    return [[float((a - b).abs().max()), float(b.abs().max())]
            for a, b in zip(hidden["kernel"], hidden["chunked"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b",
                    choices=("rwkv6-1.6b", "zamba2-1.2b", "mixtral-8x22b",
                             "pixtral-12b", "whisper-tiny"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (mixtral: 4 "
                         "unless given)")
    args = ap.parse_args(argv)
    arch = args.arch
    import torch
    if not torch.cuda.is_available():
        print("route_noise: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import WHISPER_PROMPT, fused_requests
    from repro_torch import configs
    from repro_torch.kernels import linear_attn as la
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    base = configs.get_config(arch)
    layers = args.layers or (MIXTRAL_LAYERS if arch == "mixtral-8x22b"
                             else None)
    if layers:
        base = dataclasses.replace(base, n_layers=layers)
    if arch in ("mixtral-8x22b", "pixtral-12b", "whisper-tiny"):
        pairs = ((("kernel", 64), ("naive", 64)),
                 (("naive", 64), ("chunked", 64)),
                 (("kernel", 64), ("chunked", 64)))
    else:
        pairs = ((("kernel", 64), ("chunked", 64)),
                 (("chunked", 64), ("chunked", 32)),
                 (("kernel", 64), ("kernel", 32)))
    key = {"pixtral-12b": "patches", "whisper-tiny": "frames"}.get(arch)
    prompt_len = WHISPER_PROMPT if arch == "whisper-tiny" else 512
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, param_dtype=dtype)
        model = T.Transformer(cfg, device="cuda",
                              generator=torch.Generator("cuda")
                              .manual_seed(0))
        state = model.state_dict()
        sets = {}
        if key is not None:         # chip_smoke.py's fused requests
            sets[f"with {key}"] = [b for _, b in fused_requests(
                torch, np, cfg, key, prompt_len)]
        if key != "frames":         # text only, as Engine.run serves
            rng = np.random.default_rng(0)
            sets["text only"] = [{"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab, size=(prompt_len,), dtype=np.int32),
                device="cuda")[None]} for _ in range(8)]
        for name, batches in sets.items():
            diffs, scale, routing = routes(T, cfg, state, batches, pairs)
            print(json.dumps({"arch": arch, "n_layers": cfg.n_layers,
                              "dtype": dtype, "prompts": name,
                              "logits_max_abs_diff": diffs,
                              "logits_up_to": scale,
                              "routing_decisions_differing_of": routing}),
                  flush=True)
        if dtype == "bfloat16":
            print(json.dumps({"dtype": dtype, "layer_hidden_diff_and_max":
                              layer_divergence(T, cfg, state, batches[0])}),
                  flush=True)
        del model, state, sets, batches
        torch.cuda.empty_cache()
    if arch == "whisper-tiny":
        print(json.dumps({"card": torch.cuda.get_device_name(0)}))
        return 0

    # served tokens (kernel prefill, recurrence decode) against a
    # teacher-forced forward through each route, bf16
    from repro_torch.serve import engine
    cfg = base
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(512,), dtype=np.int32)
               for _ in range(8)]
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    eng = engine.Engine(model, slots=4, max_len=512 + 32 + 1)
    for rid, pr in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=32))
    done = eng.run()
    for impl in ("kernel", "chunked"):
        m = T.Transformer(dataclasses.replace(cfg, attn_impl=impl),
                          device="meta")
        m.load_state_dict(model.state_dict(), assign=True)
        gaps = []
        for r in done:
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            logits, _ = T.forward(m, {"tokens": torch.as_tensor(
                seq, device="cuda")[None]})
            pos = logits[0, len(r.prompt) - 1:]
            picked = pos.gather(1, torch.as_tensor(
                r.out, device="cuda")[:, None])[:, 0]
            gaps.append(pos.amax(1) - picked)
        gaps = torch.cat(gaps)
        print(json.dumps({"selfcheck_forward_route": impl,
                          "worst_gap": float(gaps.max()),
                          "argmax_equal": int((gaps == 0).sum()),
                          "served": int(gaps.numel()),
                          "gaps_above_0.1": int((gaps > 0.1).sum())}),
              flush=True)
    del model, m, eng
    torch.cuda.empty_cache()
    if arch != "rwkv6-1.6b":
        print(json.dumps({"card": torch.cuda.get_device_name(0)}))
        return 0

    # the kernel against its plain version with the model's decays
    g = np.random.default_rng(1)
    bh, t, dk = 32, 512, 64
    r, k, v = (torch.from_numpy(g.standard_normal((bh, t, dk))
                                .astype(np.float32)).cuda()
               .to(torch.bfloat16) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(-4 + 0.01 * g.standard_normal(
        (bh, t, dk)))).astype(np.float32)).cuda()
    u = (torch.from_numpy(g.standard_normal((bh, dk)).astype(np.float32))
         * 0.1).cuda().to(torch.bfloat16)
    got, gs = la.linear_attention_state(r, k, v, w, u, chunk=64)
    want, ws = ref.linear_attention_state(r, k, v, w, u)
    diff = (got.float() - want.float()).abs()
    ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
    print(json.dumps({
        "kernel_vs_plain_model_decay": {
            "max_abs_err": float(diff.max()),
            "outputs_up_to": float(want.float().abs().max()),
            "share_off_by_more_than_one_ulp": float(
                (diff > ulp * 1.01).float().mean()),
            "share_not_equal": float((diff > 0).float().mean()),
            "state_max_abs_err": float((gs - ws).abs().max()),
            "state_up_to": float(ws.abs().max())}}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
