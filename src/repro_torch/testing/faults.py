"""Deterministic fault injection for the exploration stack.

Every failure path the fault-tolerant sweep machinery claims to handle —
worker crashes, stuck chunks, corrupted cache entries, a broken torch
backend — must be reproducible on demand or it is untested by definition.
This module is the single switchboard: production code calls
:func:`fire` at named *sites* (cheap no-ops unless a fault plan is
active), and tests/CI activate a plan through :func:`install` or the
``REPRO_FAULTS`` environment variable.

**Spec grammar.**  A plan is a comma-separated list of rules::

    REPRO_FAULTS="kill_worker:3,corrupt_cache:1,delay_chunk:1:0.75"

    rule   := site ":" occ [":" arg]
    occ    := positive int   -- fire on the Nth hit of the site, once
            | "*"            -- fire on every hit
    arg    := site-specific string (seconds for delay_chunk, a candidate
              name substring for kill_candidate, free-form otherwise)

Occurrence counting is per process and per rule, which makes the plan
fully deterministic — no randomness is involved (``seed=N`` may appear
as a rule and seeds :attr:`FaultInjector.rng` for future probabilistic
sites; nothing built-in consumes it today).

**One-shot across processes.**  An integer-occurrence rule fires *once
globally*, not once per process: the first process whose counter reaches
N atomically claims a marker file in the shared *state directory*
(``REPRO_FAULTS_STATE``, auto-created and exported by the first activation
when unset, so spawned pool workers inherit it).  Without this, a rule
like ``kill_worker:3`` would kill every respawned worker forever and
recovery could never be demonstrated.  ``occ="*"`` rules skip the claim
and fire every time — that is how a *poisoned* candidate (one that kills
any worker that touches it) is modelled.

Marker files are scoped to a *run token* (``{site}.{idx}.{token}.fired``)
minted by the first activation of a plan and inherited — via
``REPRO_FAULTS_TOKEN`` or the worker-initializer arguments — by every
process that shares the plan.  A fresh activation (new token) sweeps
every stale marker out of a reused state directory first, so claims can
never leak across pytest runs or CI retries that point
``REPRO_FAULTS_STATE`` at the same path; an *inherited* token never
sweeps (a worker must not destroy its parent's claims).

**Known sites** (:data:`SITES`):

============== ============================================== ==========
site           where it is checked                            effect
============== ============================================== ==========
kill_worker    worker, per candidate in a chunk               os._exit
kill_candidate worker, per candidate; arg = name substring    os._exit
delay_chunk    worker, chunk entry; arg = seconds (def. 0.5)  sleep
corrupt_cache  DiskCache.put; payload written corrupted       bad entry
delay_put      DiskCache.put, pre-rename; arg = seconds       sleep
fail_torch_import torchsim.require_torch                     raise
fail_compile   graphcache.CompileCache.load_or_compile        raise
fail_lockstep  batchsim._run_lockstep entry                   raise
============== ============================================== ==========

The module lives under ``repro_torch.testing`` but has no dependency on the
rest of the package (core modules import it, never the reverse), and an
inactive injector costs one attribute load + ``is None`` test per site.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import random
import uuid
from typing import Dict, List, Optional, Tuple, Union

ENV_SPEC = "REPRO_FAULTS"
ENV_STATE = "REPRO_FAULTS_STATE"
ENV_TOKEN = "REPRO_FAULTS_TOKEN"

#: Site names production code may fire; unknown sites in a spec fail fast.
SITES = ("kill_worker", "kill_candidate", "delay_chunk", "corrupt_cache",
         "delay_put", "fail_torch_import", "fail_compile", "fail_lockstep")


class InjectedFault(RuntimeError):
    """What a raising site throws: an engine fault on demand.  The
    Explorer demotes on it even on the card, where a real fault of the
    torch engine re-raises."""


class _Rule:
    __slots__ = ("occ", "arg", "count")

    def __init__(self, occ: Union[int, str], arg: Optional[str]):
        self.occ = occ          # int >= 1, or "*"
        self.arg = arg
        self.count = 0          # per-process, per-rule hit counter


def _parse(spec: str) -> Tuple[Dict[str, List[_Rule]], int]:
    rules: Dict[str, List[_Rule]] = {}
    seed = 0
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        bits = part.split(":", 2)
        if len(bits) < 2:
            raise ValueError(f"fault rule {part!r}: want site:occ[:arg]")
        site, occ_s = bits[0], bits[1]
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(valid: {', '.join(SITES)})")
        occ: Union[int, str]
        if occ_s == "*":
            occ = "*"
        else:
            occ = int(occ_s)
            if occ < 1:
                raise ValueError(f"fault rule {part!r}: occurrence must be "
                                 f">= 1 or '*'")
        rules.setdefault(site, []).append(
            _Rule(occ, bits[2] if len(bits) > 2 else None))
    return rules, seed


class FaultInjector:
    """One activated fault plan: parsed rules + the shared claim dir.

    ``run_token`` scopes the one-shot markers: processes sharing a plan
    (parent + its pool workers) must share the token so a claim in one
    blocks the others, while a *fresh* activation (token minted here)
    starts from a clean slate — it sweeps any stale markers a previous
    run left in a reused state directory.
    """

    def __init__(self, spec: str, state_dir: Optional[str] = None,
                 run_token: Optional[str] = None):
        self.spec = spec
        self._rules, seed = _parse(spec)
        self.rng = random.Random(seed)
        if state_dir is None:
            state_dir = tempfile.mkdtemp(prefix="repro-faults-")
        self.state_dir = state_dir
        os.makedirs(self.state_dir, exist_ok=True)
        if run_token is None:
            # activation root: fresh scope — stale markers (any token,
            # including pre-token legacy names) must not shadow our claims
            self.run_token = uuid.uuid4().hex[:12]
            self._sweep_stale()
        else:
            self.run_token = run_token

    def _sweep_stale(self) -> None:
        try:
            names = os.listdir(self.state_dir)
        except OSError:
            return
        for n in names:
            if n.endswith(".fired"):
                try:
                    os.unlink(os.path.join(self.state_dir, n))
                except OSError:
                    pass

    def _claim(self, site: str, idx: int) -> bool:
        """Atomically claim rule ``idx`` of ``site`` across every process
        sharing the state dir and run token; True exactly once per rule."""
        path = os.path.join(self.state_dir,
                            f"{site}.{idx}.{self.run_token}.fired")
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False
        except OSError:
            # unshareable state dir: degrade to process-local one-shot
            return True

    def fired(self, site: str) -> int:
        """How many of ``site``'s integer-occurrence rules have been
        claimed (by any process sharing this plan's token) — the
        assertion helper for tests/CI."""
        try:
            names = os.listdir(self.state_dir)
        except OSError:
            return 0
        suffix = f".{self.run_token}.fired"
        return sum(1 for n in names
                   if n.startswith(site + ".") and n.endswith(suffix))

    def fire(self, site: str, match: Optional[str] = None
             ) -> Union[None, bool, str]:
        """Advance ``site``'s counters; truthy (the rule's arg, or True)
        when a rule triggers now.  ``match`` filters arg-carrying rules to
        those whose arg is a substring of it (the kill_candidate form) —
        non-matching hits are not counted."""
        rules = self._rules.get(site)
        if not rules:
            return None
        for idx, r in enumerate(rules):
            if match is not None and r.arg and r.arg not in match:
                continue
            r.count += 1
            if r.occ == "*" or (r.count == r.occ and self._claim(site, idx)):
                return r.arg if r.arg is not None else True
        return None


_INJECTOR: Optional[FaultInjector] = None


def activate(spec: Optional[str],
             state_dir: Optional[str] = None,
             run_token: Optional[str] = None) -> Optional[FaultInjector]:
    """(Re)activate a plan in this process — the worker-initializer entry
    point.  Exports the state dir and run token to the environment so
    processes spawned *after* activation share the one-shot claims.
    ``run_token=None`` mints a fresh token (and sweeps stale markers);
    workers must pass the parent's token through so they inherit its
    claim scope instead of resetting it.  ``spec`` falsy deactivates."""
    global _INJECTOR
    if not spec:
        _INJECTOR = None
        return None
    _INJECTOR = FaultInjector(spec, state_dir, run_token)
    os.environ[ENV_SPEC] = spec
    os.environ[ENV_STATE] = _INJECTOR.state_dir
    os.environ[ENV_TOKEN] = _INJECTOR.run_token
    return _INJECTOR


def deactivate() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> Optional[FaultInjector]:
    return _INJECTOR


def current() -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """``(spec, state_dir, run_token)`` to ship to a worker initializer,
    or ``(None, None, None)`` when no plan is active."""
    if _INJECTOR is None:
        return None, None, None
    return _INJECTOR.spec, _INJECTOR.state_dir, _INJECTOR.run_token


def token() -> Optional[str]:
    """Opaque identity of the active plan (pool-key ingredient: a changed
    plan must get fresh workers so it reaches their initializers)."""
    if _INJECTOR is None:
        return None
    return f"{_INJECTOR.spec}@{_INJECTOR.state_dir}@{_INJECTOR.run_token}"


def fire(site: str, match: Optional[str] = None) -> Union[None, bool, str]:
    """The production-code hook: no-op (None) unless a plan is active."""
    if _INJECTOR is None:
        return None
    return _INJECTOR.fire(site, match)


def sleep_if_injected(site: str = "delay_chunk",
                      default_s: float = 0.5) -> float:
    """Fire ``site`` and sleep its arg seconds; returns the delay (0.0
    when the site did not trigger)."""
    got = fire(site)
    if not got:
        return 0.0
    try:
        delay = float(got) if got is not True else default_s
    except (TypeError, ValueError):
        delay = default_s
    time.sleep(delay)
    return delay


@contextlib.contextmanager
def install(spec: str, state_dir: Optional[str] = None):
    """Context manager for tests: activate ``spec`` (fresh temp state dir
    unless given), yield the injector, then restore the previous plan and
    environment and remove the temp dir."""
    prev = _INJECTOR
    prev_env = {k: os.environ.get(k)
                for k in (ENV_SPEC, ENV_STATE, ENV_TOKEN)}
    made_dir = state_dir is None
    inj = activate(spec, state_dir)
    try:
        yield inj
    finally:
        globals()["_INJECTOR"] = prev
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if made_dir and inj is not None:
            shutil.rmtree(inj.state_dir, ignore_errors=True)


# Environment-driven activation (CLI / CI chaos runs): the plan is live
# from the first import, before any pool exists.  A token already in the
# environment means some ancestor process is the activation root — inherit
# its claim scope instead of minting (and sweeping) a fresh one.
if os.environ.get(ENV_SPEC):
    activate(os.environ[ENV_SPEC], os.environ.get(ENV_STATE),
             os.environ.get(ENV_TOKEN))
