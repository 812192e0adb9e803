"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

The JAX package's ``repro/launch/train.py`` on the port: the arch's
reduced smoke config trained with the full substrate — the synthetic
data pipeline, the fault-tolerant supervisor loop, atomic asynchronous
checkpoints — and a check that the loss fell.  Runs on the card unless
``--device cpu`` is given.  The config's attention runs
``attn_impl="chunked"``, the JAX package's training arithmetic: the
kernels have no backward.  Without ``--ckpt-dir`` the checkpoints go to
a temporary directory, deleted at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    from repro_torch import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps at which to kill the worker")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=default_device())
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.supervisor import FailureInjector, Supervisor

    cfg = dataclasses.replace(configs.get_smoke(args.arch),
                              attn_impl="chunked")
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 2),
        total_steps=args.steps))
    params, opt_state = step_mod.init_train_state(cfg, tcfg,
                                                  device=args.device)
    print(f"arch={cfg.name} params≈{params.param_count():,} "
          f"device={params.device} attn_impl={cfg.attn_impl}")
    train_step = step_mod.make_train_step(cfg, tcfg)

    ds = SyntheticLM(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                vocab=cfg.vocab))
    inject = tuple(int(s) for s in args.inject_failures.split(",") if s)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        sup = Supervisor(train_step, ds, args.ckpt_dir or tmp,
                         ckpt_every=args.ckpt_every,
                         injector=FailureInjector(at_steps=inject),
                         async_ckpt=True)
        t0 = time.perf_counter()
        params, opt_state, report = sup.run(params, opt_state, args.steps)
        dt = time.perf_counter() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    first = np.mean(report.losses[:5])
    last = np.mean(report.losses[-5:])
    print(f"steps={report.steps_done} restarts={report.restarts} "
          f"replayed={report.steps_replayed} "
          f"loss {first:.3f}→{last:.3f} ({tok_s:,.0f} tok/s)")
    assert last < first, "training did not reduce loss"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
