"""Persistent on-disk sweep store — graphs and simulations across runs.

The exploration engine's in-memory caches die with the process; co-design
is iterative across *runs* (re-run the sweep tomorrow with one more
axis), so the expensive artifacts — frozen augmented graphs and schedule-free
simulation results — are also persisted to a content-addressed directory.

Keys are plain strings built from *content*, never identity: the trace
fingerprint (sha256 over the serialised events), the eligibility/system
signature the in-memory graph cache already uses, and the pool layout +
policy for simulations.  Entries are self-verifying:

    <64 hex chars: sha256 of payload>\\n<pickled {"key": ..., "value": ...}>

A read re-hashes the payload and compares the stored key text, so truncated
files, bit flips, and hash collisions (a *stale* entry written under another
key) all degrade to a cache miss — the caller recomputes and overwrites;
nothing crashes.  Writes are atomic (temp file + rename) so a killed sweep
never leaves a half-written entry behind.

**The content-hash registry protocol.**  Entries are filed under
``sha256(key_text).pkl``, and that filename hash doubles as a wire-level
name: a reader that only holds the 64-char hash — the exploration engine's
process-pool workers, which keep a persistent hash→``FrozenGraph``
registry and are handed hashes instead of re-pickled payloads — fetches
via :meth:`DiskCache.get_hashed`, which re-hashes the embedded key text
and verifies it against the requested hash.  The protocol's invariant:
*any* value served (by ``get`` or ``get_hashed``) passed the payload
digest check **and** the key/hash comparison, so a worker can trust a
self-served graph exactly as much as one shipped from the parent.  Cache
keys are namespaced by engine equivalence tier where it matters (see
``repro_torch.core.explore._sim_disk_text``): exact engines share one sim
namespace, the torch rtol tier gets its own.

Three entry families share the store, all under the same wire format:
``graph`` (frozen payloads), ``sim`` / ``sim-<tier>`` (schedule-free
results) and ``orders`` (the multi-order replay library's dispatch
orders + signature maps, keyed by ``FrozenGraph.content_hash()`` +
policy — deliberately *not* tier-namespaced, since orders are recorded
by the exact path and re-validated per lane by every engine).  Order
payloads get one more gate on top of the digest check: every order is
topologically validated against the graph before it is ever replayed
(``repro_torch.core.replay.order_valid``), so even an internally-consistent
entry re-homed from another graph degrades to rediscovery.

**Quarantine.**  An entry that *exists* but fails the digest/decode check
is not just a miss — left in place it would be re-read, re-hashed and
re-rejected on every run forever.  The failed file is moved aside once
into ``<root>/quarantine/`` (preserved for post-mortem, never re-read;
the next ``put`` under the same key recreates a clean entry) and counted
on :attr:`DiskCache.quarantined`, which the Explorer folds into
``CacheStats.cache_quarantined``.  A *missing* file and a *stale* entry
(digest fine, key text belongs to another key — a legitimate collision
artifact) both remain plain misses.  Writes are crash-atomic: payload to
a temp file, ``fsync``, then ``os.replace`` — a worker killed mid-write
leaves at worst a ``.tmp`` orphan, which construction sweeps away once
it is older than an hour (young orphans may belong to a live writer).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from typing import Any, Iterable, Optional

from ..testing import faults

#: Construction removes abandoned ``.tmp`` files older than this; younger
#: ones may be in-flight writes of a concurrent process.
TMP_MAX_AGE_S = 3600.0


def sha256_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def trace_fingerprint(trace, include_times: bool = True) -> str:
    # noqa: ANN001 — Trace (import would cycle)
    """Content hash of the *graph-determining* trace content.

    Region keys are raw addresses (``id()`` / data pointers) that change
    every process — but dependence inference only uses key *equality*, so
    keys are canonically relabelled by first occurrence: two traces of the
    same program share a fingerprint across runs.  ``include_times=False``
    drops the measured per-event times — correct whenever costs come from
    an ``smp_seconds_fn`` (which the Explorer fingerprints separately);
    with it the re-traced measurement noise would defeat cross-run reuse.
    """
    h = hashlib.sha256()
    canon: dict = {}
    for e in trace.events:
        acc = []
        for key, dirn, nbytes in e.accesses:
            cid = canon.setdefault(key, len(canon))
            acc.append((cid, dirn, nbytes))
        rec = (e.index, e.name, tuple(acc), tuple(e.devices), e.flops,
               e.elapsed_smp if include_times else None)
        h.update(repr(rec).encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


class DiskCache:
    """Content-addressed pickle store with integrity-checked reads."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        #: integrity-failed entries moved to ``quarantine/`` by this handle
        self.quarantined = 0
        self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        """Remove ``.tmp`` orphans left by killed writers (age-gated so a
        live writer's in-flight temp file is never yanked away)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        cutoff = time.time() - TMP_MAX_AGE_S
        for name in names:
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(self.root, name)
            try:
                if os.path.getmtime(path) < cutoff:
                    os.unlink(path)
            except OSError:
                pass

    def _path(self, key_text: str) -> str:
        return os.path.join(self.root, sha256_text(key_text) + ".pkl")

    def _quarantine(self, path: str) -> None:
        """Move an integrity-failed entry aside so it is never re-read;
        the next ``put`` under its key writes a fresh file."""
        qdir = os.path.join(self.root, "quarantine")
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, os.path.join(qdir, os.path.basename(path)))
        except OSError:
            try:                                  # immovable: drop instead —
                os.unlink(path)                   # never leave it live
            except OSError:
                return
        self.quarantined += 1

    def _read_wrapper(self, path: str) -> Optional[dict]:
        """Integrity-checked ``{"key": ..., "value": ...}`` wrapper from an
        entry file, or ``None``: the single place that understands the
        ``<64-hex digest>\\n<pickle>`` wire format.  Truncation, bit flips
        and undecodable payloads degrade to a miss *and* quarantine the
        file; a missing file is a plain miss.  Callers add their own
        staleness check (key text vs this entry's embedded key)."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        try:
            if len(blob) >= 65 and blob[64:65] == b"\n":
                payload = blob[65:]
                digest = hashlib.sha256(payload).hexdigest().encode("ascii")
                if digest == blob[:64]:
                    return pickle.loads(payload)
        except Exception:                         # noqa: BLE001 — any decode
            pass                                  # failure quarantines below
        self._quarantine(path)
        return None

    # ------------------------------------------------------------------
    def get(self, key_text: str) -> Optional[Any]:
        """Stored value, or ``None`` on miss / corruption / stale key."""
        wrapper = self._read_wrapper(self._path(key_text))
        if not isinstance(wrapper, dict) or wrapper.get("key") != key_text:
            return None                           # stale entry / collision
        return wrapper["value"]

    def put(self, key_text: str, value: Any) -> None:
        payload = pickle.dumps({"key": key_text, "value": value},
                               protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(payload).hexdigest().encode("ascii")
        if faults.fire("corrupt_cache"):
            # digest of the clean payload over a flipped-byte body: the
            # entry lands on disk looking complete but trips the read-side
            # integrity check — the torn/bit-rotten entry, on demand.
            payload = payload[:-1] + bytes([payload[-1] ^ 0xFF])
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(digest + b"\n" + payload)
                f.flush()
                os.fsync(f.fileno())              # crash-atomic: data is
            # deterministic race widener: holds the written-but-unrenamed
            # window open so concurrent-writer tests can overlap it at will
            faults.sleep_if_injected("delay_put", 0.05)
            os.replace(tmp, self._path(key_text))  # durable before rename
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get_hashed(self, key_hash: str) -> Optional[Any]:
        """Stored value by the sha256 *of* its key text, or ``None``.

        Entries are filed under ``sha256(key_text).pkl``, so a reader that
        only knows the fingerprint — e.g. a process-pool worker handed a
        64-char graph hash instead of a re-pickled FrozenGraph — can still
        fetch and verify the entry: same integrity path as :meth:`get`,
        with the wrapper's embedded key text re-hashed and compared against
        ``key_hash``, so a stale or colliding entry degrades to a miss
        exactly like the full-text path.
        """
        wrapper = self._read_wrapper(
            os.path.join(self.root, key_hash + ".pkl"))
        try:
            if not isinstance(wrapper, dict) or \
                    sha256_text(wrapper.get("key", "")) != key_hash:
                return None
            return wrapper["value"]
        except Exception:                         # noqa: BLE001 — key type
            return None

    # ------------------------------------------------------------------
    def __contains__(self, key_text: str) -> bool:
        return self.get(key_text) is not None

    def entries(self) -> Iterable[str]:
        """Filenames of stored entries (diagnostics / tests)."""
        return sorted(f for f in os.listdir(self.root) if f.endswith(".pkl"))

    def clear(self) -> int:
        n = 0
        for f in list(self.entries()):
            try:
                os.unlink(os.path.join(self.root, f))
                n += 1
            except OSError:
                pass
        return n
