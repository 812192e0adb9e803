"""Fault-tolerant training supervisor: checkpoint/restart with failure
injection and straggler detection — the JAX package's
``repro/train/supervisor.py``.

The supervisor owns the outer loop a cluster controller runs per worker
group: step → (maybe) checkpoint → watch for failures → on failure,
restore the latest checkpoint and replay the data stream from there
(deterministic by construction of :mod:`.data`).  ``FailureInjector``
provides the chaos-monkey schedule the tests use; straggler handling
feeds the per-host step-time EMA into the data pipeline's ``rebalance``.

The train step updates the model and the optimizer state in place, so a
restore loads into them in place (:func:`.checkpoint.restore_into`).  As
in the JAX package, a failure before the first checkpoint restarts from
step 0 with the parameters as they stand, already updated by the steps
before the failure: such a run is not the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np

from . import checkpoint as ckpt_mod
from .data import SyntheticLM


class InjectedFailure(RuntimeError):
    """Simulated worker death (e.g. preemption, link glitch, host OOM)."""


@dataclasses.dataclass
class FailureInjector:
    """Raise at the configured global steps (once each)."""

    at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatch:
    """EMA of per-host step time; flags hosts slower than mean × threshold."""

    n_hosts: int
    threshold: float = 1.5
    alpha: float = 0.3
    ema: Optional[np.ndarray] = None

    def observe(self, host_times: np.ndarray) -> Optional[int]:
        if self.ema is None:
            self.ema = host_times.astype(float).copy()
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * host_times
        mean = float(self.ema.mean())
        worst = int(self.ema.argmax())
        if self.ema[worst] > self.threshold * mean and self.n_hosts > 1:
            return worst
        return None


@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    steps_replayed: int
    rebalances: List[Any]
    losses: List[float]


class Supervisor:
    """Outer training loop with checkpoint/restart semantics."""

    def __init__(self, train_step: Callable, data: SyntheticLM,
                 ckpt_dir: str, *, ckpt_every: int = 10, keep: int = 3,
                 injector: Optional[FailureInjector] = None,
                 straggler: Optional[StragglerWatch] = None,
                 async_ckpt: bool = False):
        self.train_step = train_step
        self.data = data
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.injector = injector or FailureInjector()
        self.straggler = straggler
        self.async_ckpt = async_ckpt

    def run(self, params, opt_state, n_steps: int,
            host_time_fn: Optional[Callable[[int], np.ndarray]] = None
            ) -> tuple:
        """``(params, opt_state, SupervisorReport)`` after ``n_steps``
        steps; ``params`` is the model, trained in place."""
        state = {"params": params, "opt": opt_state}
        step = 0
        restarts = replayed = 0
        losses: List[float] = []
        rebalances: List[Any] = []
        pending: List[Any] = []

        while step < n_steps:
            try:
                batch = self.data.global_batch(step)
                self.injector.maybe_fail(step)
                state["params"], state["opt"], metrics = self.train_step(
                    state["params"], state["opt"], batch)
                losses.append(float(metrics["loss"]))
                if self.straggler and host_time_fn is not None:
                    slow = self.straggler.observe(host_time_fn(step))
                    if slow is not None:
                        rebalances.append((step, slow,
                                           list(self.data.rebalance(slow))))
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    out = ckpt_mod.save(self.ckpt_dir, step, state,
                                        keep=self.keep,
                                        asynchronous=self.async_ckpt)
                    if self.async_ckpt:
                        pending.append(out)
            except InjectedFailure:
                restarts += 1
                for t in pending:          # quiesce in-flight writes
                    t.join()
                pending.clear()
                last = ckpt_mod.latest_step(self.ckpt_dir)
                if last is None:           # restart from scratch
                    replayed += step
                    step = 0
                    continue
                ckpt_mod.restore_into(self.ckpt_dir, last, state)
                replayed += step - last
                step = last
        for t in pending:
            t.join()
        report = SupervisorReport(steps_done=step, restarts=restarts,
                                  steps_replayed=replayed,
                                  rebalances=rebalances, losses=losses)
        return state["params"], state["opt"], report
