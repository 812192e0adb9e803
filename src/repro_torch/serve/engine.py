"""Serving engine: prefill and decode steps and a simple batched scheduler.

The JAX package's engine (``repro/serve/engine.py``) on the port's model:
``make_serve_step``/``make_prefill_step`` return the step functions, with
greedy ``argmax`` on the device; :class:`Engine` is the host-side loop,
with the same batching — each request prefilled alone, every entry of the
slots' caches concatenated on the batch axis (k/v of attention layers and
of zamba2's shared sites, the states of RWKV6 and Mamba2 layers,
whisper's cross-attention k/v), and the slots decoded in lock-step from
``max(prompt lengths) + 1``.  With prompts of unequal length the shorter
ones therefore attend to zero keys and decode at shifted positions, as in
the JAX package (ROADMAP §3); an RWKV6 state carries no positions, so its
requests decode as if alone.  Like the JAX engine, :meth:`Engine.run`
feeds each prefill its tokens alone: it serves pixtral text-only, and
not whisper, whose prefill needs ``frames``.  Requests with ``patches``
or ``frames`` go through :func:`make_prefill_step` with those in the
batch and a :class:`DecodeRunner` loaded at ``length = (patch_tokens +)
T + 1``, the step entry points the JAX package's dry-run lowers.

The decode step is the counterpart of the JAX engine's ``jax.jit(
make_serve_step(cfg))``: a :class:`DecodeRunner` held in a
:class:`~repro_torch.core.graphcache.CompileCache` under the signature
(model, config, batch, ``max_len``, dtype, device).  On the card it is a
captured CUDA graph over static buffers — the tokens ``(B, 1)`` int32,
every entry of the cache (each layer's and each shared site's, as
:func:`~repro_torch.models.transformer.init_cache` lays them out), and
the cache length as a 0-d device tensor, which
the graph advances itself, so that a step copies nothing to the device.
Each batch's prefilled caches are copied into the static cache once.  A
last batch with fewer requests than slots gets a capture of its own batch
size (never padded), so every request decodes in a batch of the size it
would have eagerly.  Prefill stays eager, jitted per prompt length in the
JAX engine.  ``graphs=False`` runs the same step eagerly on the same
buffers (the other side of an A/B check on the card).

The engine counts what a serving run needs for its throughput: prompt
tokens and seconds of prefill, steps and seconds of decode (host clock;
each step ends in a copy of its tokens to the host, which waits for the
device), and apart from them the seconds spent finding or capturing the
decode step's graph (``capture_s``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import graphcache
from ..core.graphcache import CompileCache
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


class DecodeRunner:
    """The decode step of one (model, batch, ``max_len``) over static
    buffers: ``tokens (B, 1)`` int32, ``cache`` (every entry, as
    :func:`~repro_torch.models.transformer.init_cache` makes it) and
    ``length`` (0-d int64).  A step writes the next tokens into
    ``tokens``, its logits into ``logits`` and advances ``length``; on the
    card (``graphs``) it is one replay of a captured CUDA graph, else the
    step run eagerly.  The runner holds its model."""

    #: Kernel libraries the step needs: none (decode runs the plain
    #: attention and recurrence, as the JAX engine does).
    libraries = ()

    def __init__(self, model: T.Transformer, batch: int, max_len: int, *,
                 graphs: bool, cache: Optional[CompileCache] = None):
        device = model.device
        self.model = model
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device)
        self.cache = T.init_cache(model.cfg, batch, max_len, device=device)
        # the warm-up before capture decodes at position 0 of the zeroed
        # buffers; load() overwrites every one of them
        self.length = torch.ones((), dtype=torch.int64, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.graph = None
        self.cc = cache
        if graphs and device.type == "cuda":
            self.graph = graphcache.capture(self._body, cache)

    def _body(self) -> None:
        logits, _ = T.decode_step(self.model, self.tokens, self.cache,
                                  self.length)
        self.logits = logits
        self.tokens.copy_(torch.argmax(logits[:, -1], dim=-1)
                          .to(torch.int32)[:, None])
        self.length.add_(1)

    def load(self, caches: List[Cache], tokens: torch.Tensor,
             length: int) -> None:
        """A batch's prefilled caches (one per request, batch axis 0),
        its first tokens and its cache length, copied in."""
        for entry, static in enumerate(self.cache):
            for name, buf in static.items():
                torch.cat([c[entry][name] for c in caches], out=buf)
        self.tokens.copy_(tokens)
        self.length.fill_(length)

    def step(self) -> torch.Tensor:
        """One decode step; returns the token buffer."""
        if self.graph is None:
            self._body()
        else:
            graphcache.replay(self.graph)
            if self.cc is not None:
                self.cc.note_replays(1)
        return self.tokens


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
    capture_s: float = 0.0      # finding or capturing the decode step


class Engine:
    """Fixed-slot batching: the active slots share one cache buffer; the
    queue is drained ``slots`` requests at a time.

    The decode step's runners live in ``compile_cache`` (default: one of
    the engine's own, in memory); ``graphs=False`` decodes eagerly."""

    def __init__(self, model: T.Transformer, *, slots: int = 4,
                 max_len: int = 256,
                 compile_cache: Optional[CompileCache] = None,
                 graphs: bool = True):
        self.model = model
        self.slots, self.max_len = slots, max_len
        self.prefill_one = make_prefill_step(model, max_len)
        self.step = make_serve_step(model)
        self.compile_cache = CompileCache() if compile_cache is None \
            else compile_cache
        self.graphs = graphs
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()
        #: The logits ``(B, 1, V)`` of the last decode step run.
        self.last_logits: Optional[torch.Tensor] = None

    def decoder(self, batch: int) -> DecodeRunner:
        """The decode runner of ``batch`` slots: the compile cache's (a
        memory hit, or captured now) unless ``graphs`` is off, when a
        fresh eager one serves."""
        model = self.model
        if not self.graphs:
            return DecodeRunner(model, batch, self.max_len, graphs=False)
        signature = ("decode", id(model), repr(model.cfg), batch,
                     self.max_len, str(model.cfg.dtype), str(model.device))
        cc = self.compile_cache
        return cc.load_or_compile(signature, lambda: DecodeRunner(
            model, batch, self.max_len, graphs=True, cache=cc))

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
            # decode lock-step to the longest request
            steps = max(r.max_new - 1 for r in active)
            if steps > 0:
                t0 = time.perf_counter()
                runner = self.decoder(len(active))
                self.stats.capture_s += time.perf_counter() - t0
                runner.load(caches, torch.cat(tokens), max(lengths) + 1)
            for _ in range(steps):
                t0 = time.perf_counter()
                host = runner.step()[:, 0].tolist()
                self.stats.decode_s += time.perf_counter() - t0
                self.stats.decode_steps += 1
                for i, r in enumerate(active):
                    if len(r.out) < r.max_new:
                        r.out.append(host[i])
            if steps > 0:
                self.last_logits = runner.logits.clone()
            for r in active:
                r.done = True
                self.finished.append(r)
        return self.finished
