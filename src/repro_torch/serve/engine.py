"""Serving engine: prefill and decode steps and a simple batched scheduler.

The JAX package's engine (``repro/serve/engine.py``) on the port's model:
``make_serve_step``/``make_prefill_step`` return the step functions, with
greedy ``argmax`` on the device; :class:`Engine` is the host-side loop,
with the same batching — each request prefilled alone, every entry of the
slots' caches concatenated on the batch axis (k/v of attention layers,
the states of RWKV6 layers), and the slots decoded in lock-step from
``max(prompt lengths) + 1``.  With prompts of unequal length the shorter
ones therefore attend to zero keys and decode at shifted positions, as in
the JAX package (ROADMAP §3); an RWKV6 state carries no positions, so its
requests decode as if alone.

The engine counts what a serving run needs for its throughput: prompt
tokens and seconds of prefill, steps and seconds of decode (host clock;
each step ends in a copy of its tokens to the host, which waits for the
device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models import transformer as T

Cache = List[Dict[str, torch.Tensor]]


def make_serve_step(model: T.Transformer
                    ) -> Callable[[torch.Tensor, Cache, int],
                                  Tuple[torch.Tensor, Cache]]:
    """One decode step: ``(tokens (B, 1), cache, length) -> (next tokens
    (B, 1) int32, cache)``, the cache updated in place.  Greedy sampling on
    the device."""

    def serve_step(tokens, cache, length):
        logits, cache = T.decode_step(model, tokens, cache, length)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step


def make_prefill_step(model: T.Transformer, max_len: int
                      ) -> Callable[[Dict[str, torch.Tensor]],
                                    Tuple[torch.Tensor, Cache]]:
    """Prefill the prompt; returns ``(first sampled token (B, 1), cache)``."""

    def prefill_step(batch):
        logits, cache = T.prefill(model, batch, max_len=max_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (T,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_steps: int = 0
    decode_s: float = 0.0


class Engine:
    """Fixed-slot batching: the active slots share one cache buffer; the
    queue is drained ``slots`` requests at a time."""

    def __init__(self, model: T.Transformer, *, slots: int = 4,
                 max_len: int = 256):
        self.model = model
        self.slots, self.max_len = slots, max_len
        self.prefill_one = make_prefill_step(model, max_len)
        self.step = make_serve_step(model)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self) -> List[Request]:
        """Drain the queue (batch-of-one prefill, batched decode)."""
        device = self.model.device
        while self.queue:
            active = [self.queue.pop(0)
                      for _ in range(min(self.slots, len(self.queue)))]
            caches, tokens, lengths = [], [], []
            for r in active:
                t0 = time.perf_counter()
                prompt = torch.as_tensor(np.asarray(r.prompt, np.int32),
                                         device=device)[None]
                tok, cache = self.prefill_one({"tokens": prompt})
                r.out.append(int(tok[0, 0]))
                self.stats.prefill_s += time.perf_counter() - t0
                self.stats.prefill_tokens += len(r.prompt)
                caches.append(cache)
                tokens.append(tok)
                lengths.append(len(r.prompt))
            cache = [{name: torch.cat([c[layer][name] for c in caches])
                      for name in caches[0][layer]}
                     for layer in range(len(caches[0]))] \
                if len(caches) > 1 else caches[0]
            toks = torch.cat(tokens)
            # decode lock-step to the longest request
            steps = max(r.max_new - 1 for r in active)
            length = max(lengths) + 1
            for _ in range(steps):
                t0 = time.perf_counter()
                toks, cache = self.step(toks, cache, length)
                host = toks[:, 0].tolist()
                self.stats.decode_s += time.perf_counter() - t0
                self.stats.decode_steps += 1
                length += 1
                for i, r in enumerate(active):
                    if len(r.out) < r.max_new:
                        r.out.append(host[i])
            for r in active:
                r.done = True
                self.finished.append(r)
        return self.finished
