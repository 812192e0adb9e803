"""Synthetic sharded data pipeline with deterministic restart and
straggler-aware host rebalancing.

The JAX package's ``repro/train/data.py``, copied (it is numpy only), so
the port trains on the very batches JAX does.  Batches are a pure
function of ``(seed, step)`` — after a checkpoint restore at step k the
pipeline regenerates exactly the batches the lost worker would have
produced (tested in test_torch_train_loop.py).  Each
simulated *host* owns a slice of the global batch; ``rebalance`` moves
slice ownership away from a slow host (the straggler-mitigation hook the
supervisor drives from its step-time EMA).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Zipf-ish token stream; labels = next-token shift of tokens."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # host h owns shares[h] examples of every global batch
        base = cfg.global_batch // cfg.n_hosts
        self.shares: List[int] = [base] * cfg.n_hosts
        for i in range(cfg.global_batch - base * cfg.n_hosts):
            self.shares[i] += 1

    # ------------------------------------------------------------- batches --
    def host_batch(self, step: int, host: int) -> Dict[str, np.ndarray]:
        """The slice of batch ``step`` owned by ``host`` (deterministic)."""
        cfg = self.cfg
        start = sum(self.shares[:host])
        n = self.shares[host]
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        # generate the full batch indexfully, slice the host's rows — this
        # keeps the global batch invariant under rebalancing
        z = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
        toks = (z % cfg.vocab).astype(np.int32)[start:start + n]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        parts = [self.host_batch(step, h) for h in range(self.cfg.n_hosts)]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}

    # ----------------------------------------------------------- rebalance --
    def rebalance(self, slow_host: int, fraction: float = 0.5) -> List[int]:
        """Move ``fraction`` of a slow host's share to the other hosts."""
        if self.cfg.n_hosts < 2:
            return self.shares
        move = int(self.shares[slow_host] * fraction)
        if move == 0:
            return self.shares
        self.shares[slow_host] -= move
        others = [h for h in range(self.cfg.n_hosts) if h != slow_host]
        for i in range(move):
            self.shares[others[i % len(others)]] += 1
        assert sum(self.shares) == self.cfg.global_batch
        return self.shares


class Prefetcher:
    """Background-thread prefetch queue over the global batches."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.global_batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            yield self.q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)
