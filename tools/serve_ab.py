#!/usr/bin/env python3
"""One arch's serving from several checkouts of the repository, in turns,
on one CUDA card: each checkout in its own process, so that two versions
are compared within one call.

For each checkout given (a directory holding ``src/repro_torch`` and
``chip_smoke.py``), builds ``--arch`` at its published widths (bf16,
``torch.Generator`` seed 0), serves ``chip_smoke.SERVE``'s traffic
(eight 512-token prompts, 32 new tokens, 4 slots) ``--reps`` times
through a fresh ``Engine`` each, and prints one JSON line: the prompt
tokens/s and the decode ms a step of each repeat (the first repeat of a
process builds the kernels).

Run: ``python3 tools/serve_ab.py --arch zamba2-1.2b build/parent . .
build/parent`` (needs a card).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ONE = """
import json, sys, time
root, arch, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root); sys.path.insert(0, root + "/src")
import numpy as np, torch
from chip_smoke import SERVE
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.serve import engine
torch.backends.cuda.matmul.allow_tf32 = False
cfg = configs.get_config(arch)
model = T.Transformer(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab, size=(SERVE["prompt_len"],),
                        dtype=np.int32) for _ in range(SERVE["requests"])]
runs = []
for _ in range(reps):
    eng = engine.Engine(model, slots=SERVE["slots"],
                        max_len=SERVE["prompt_len"] + SERVE["max_new"] + 1)
    for rid, pr in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=pr,
                                  max_new=SERVE["max_new"]))
    eng.run()
    torch.cuda.synchronize()
    st = eng.stats
    runs.append({"prefill_tok_per_s": st.prefill_tokens / st.prefill_s,
                 "decode_ms_per_step": st.decode_s / st.decode_steps * 1e3})
print(json.dumps({"checkout": root, "arch": arch, "runs": runs}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("checkouts", nargs="+")
    args = ap.parse_args(argv)
    for root in args.checkouts:
        root = str(Path(root).resolve())
        out = subprocess.run([sys.executable, "-c", ONE, root, args.arch,
                              str(args.reps)], capture_output=True,
                             text=True, check=False)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
