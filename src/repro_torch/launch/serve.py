"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id>``.

Batched serving of a smoke-sized model with weights drawn from seed 0:
prefill per request, lock-step batched greedy decode over fixed slots.
Runs on the card unless ``--device cpu`` is given; ``--arch`` is any
arch whose prefill takes tokens alone (the four dense ones,
``mixtral-8x22b``, ``llama4-maverick-400b-a17b``, ``rwkv6-1.6b``,
``zamba2-1.2b``, or ``pixtral-12b`` text-only; whisper's prefill needs
``frames``, which the engine does not feed, as in the JAX package).  The
route is the config's ``attn_impl`` (``"kernel"``: the flash kernel for
attention, the MoE archs' included, and zamba2's shared block, and the
linear-attention kernel for the prefill of RWKV6 and Mamba2, on the card;
their plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    from repro_torch import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=default_device())
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, Request

    cfg = configs.get_smoke(args.arch)
    model = T.Transformer(cfg, device=args.device)
    eng = Engine(model, slots=args.slots,
                 max_len=args.prompt_len + args.max_new + 1)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab,
                                               size=(args.prompt_len,),
                                               dtype=np.int32),
                           max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"arch={cfg.name} device={args.device} attn_impl={cfg.attn_impl} "
          f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req{r.rid}: {r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
