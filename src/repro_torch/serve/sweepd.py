"""sweepd — the crash-tolerant, deadline-aware exploration service.

``python -m repro_torch.explore serve`` turns the one-shot sweep driver
into a long-lived HTTP/JSON server that *keeps its caches warm*: one
:class:`~repro_torch.core.replay.ReplayLibrary`, one on-disk store, one
worker-pool configuration and one device for the torch engine (the
server's ``--device``: the card unless the CPU is asked for; a request
cannot choose another) shared across every request, so the questions
a design team actually asks — many near-identical sweeps of the same
application — stop paying the cold-start tax per question.  Everything
is stdlib (``http.server`` + threads); the contract is:

* **Admission control** — a bounded waiting queue; past it the server
  sheds load with ``429`` + ``Retry-After`` instead of collapsing, and
  a request whose budget expires while queued gets ``504`` with the
  queue time it paid.
* **Deadline propagation** — each request carries ``budget_s``; the
  sweep runs with ``deadline_s = budget - queue wait``, flowing into
  the Explorer's candidate-timeout/sweep-deadline machinery, so a
  response always arrives within the client's budget (candidates left
  unevaluated are reported as explicitly ``failed``, never silently
  dropped).
* **Cross-request coalescing** — concurrent requests over the same
  graph and policy merge their family evaluations into one lockstep
  batch (:mod:`repro_torch.serve.coalesce`) with bit-identical
  per-request fan-out.  Only exact ``batch`` families merge: torch
  requests never merge (their results stay in the torch engine's rtol
  tier) and sweep one at a time, each waiting for the engine within its
  budget.
* **Circuit breaker** — repeated engine demotions across requests trip
  the breaker: it pins the granted engine at the degraded tier (no new
  request burns the demotion chain to rediscover a broken engine) and
  probes full fidelity again after a cool-down.  On the card the torch
  engine never demotes: a failed card, kernel build or launch answers
  500 with the :class:`~repro_torch.DeviceError`'s text, never a
  ``batch`` answer.
* **Graceful drain** — SIGTERM/SIGINT stops admission (``503`` +
  ``/readyz`` not ready), lets in-flight sweeps finish and their
  responses flush, persists dirty dispatch orders, then exits 0.
* **Telemetry** — ``/healthz`` exposes the lifetime CacheStats failure
  counters (worker retries, pool respawns, engine demotions,
  quarantines), breaker state, coalescing hit rate and library size;
  chaos CI asserts against exactly these.

The module initialises no CUDA state at import time (the parent decides
its pool start method first — ``main`` pins
``REPRO_POOL_START=forkserver`` because a threaded server must not
fork).  Torch requests, whatever thread serves them, share the engine's
caches (locked: :mod:`repro_torch.core.torchsim`), one CUDA context and
the legacy default stream.  Every request failure maps
to a JSON error document: protocol errors are 400s, saturation 429/503,
budget exhaustion 504, and an unexpected exception is one 500 — the
server itself never dies with a request.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import threading
import time
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from typing import Any, Dict, Optional, Sequence, Tuple

from .. import DeviceError, default_device, require_cuda
from ..core.diskcache import DiskCache
from ..core.explore import ENGINE_NAMES, Explorer, orders_disk_text
from ..core.replay import ReplayLibrary
from ..core.trace import Trace
from .coalesce import Coalescer, DEFAULT_WINDOW_S
from .protocol import (FAULT_KEYS, POLICIES, ProtocolError, RETIRE_KEYS,
                       SweepRequest,
                       error_doc, get_json, parse_budget_args,
                       parse_objectives, post_json, sweep_doc,
                       timings_block)

DEFAULT_QUEUE_LIMIT = 16
DEFAULT_MAX_CONCURRENT = 4
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_BREAKER_RESET_S = 30.0
DEFAULT_DRAIN_TIMEOUT_S = 60.0


class CircuitBreaker:
    """Cross-request engine-health memory.

    The Explorer already demotes *within* a request
    (:data:`~repro_torch.core.replay.ENGINE_FALLBACK`), but a fresh
    Explorer per request re-pays the whole failing chain — a failed
    engine activation, demotion — on every query while a backend is
    down.  On the card the torch engine re-raises instead of demoting,
    so the breaker sees torch demotions only on the CPU.
    The breaker watches demotions *across* requests: after ``threshold``
    consecutive demoted sweeps it opens and grants every request the
    pinned (already-degraded, known-good) engine directly; after
    ``reset_s`` one probe request is granted full fidelity again — a
    clean probe closes the breaker, a demoted one re-opens it.

    Engines rank by :data:`~repro_torch.core.explore.ENGINE_NAMES` order
    (reference < fast < batch < torch); "capping" a request grants
    ``min(requested, pinned)`` by that rank, so a request asking for
    *less* than the pin is always honored as-is.
    """

    def __init__(self, threshold: int = DEFAULT_BREAKER_THRESHOLD,
                 reset_s: float = DEFAULT_BREAKER_RESET_S):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold!r}")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self.state = "closed"           # closed | open | half_open
        self.pinned: Optional[str] = None
        self.trips = 0
        self._consecutive = 0
        self._opened_at = 0.0
        # the outstanding half-open probe, identified by a unique token
        # handed to the probe request at admit() time — never by engine
        # name (a stale pre-trip request granted the same engine must
        # not resolve the probe)
        self._probe_token: Optional[object] = None

    @staticmethod
    def _rank(engine: str) -> int:
        return ENGINE_NAMES.index(engine)

    def _cap(self, requested: str) -> str:
        if self.pinned is None:
            return requested
        return min(requested, self.pinned, key=self._rank)

    def admit(self, requested: str) -> Tuple[str, Optional[object]]:
        """``(granted_engine, probe_token)`` for this request.  The
        token is non-None only when this request *is* the half-open
        probe; the caller must hand it back — to :meth:`observe` when
        the sweep produced a final engine, or to :meth:`release_probe`
        when the request died before one."""
        with self._lock:
            if self.state == "open" and \
                    time.monotonic() - self._opened_at >= self.reset_s:
                self.state = "half_open"
                self._probe_token = None
            if self.state == "closed":
                return requested, None
            if self.state == "half_open" and self._probe_token is None \
                    and self._rank(requested) > self._rank(self.pinned
                                                           or requested):
                # the one probe: full fidelity, resolves the state below
                self._probe_token = object()
                return requested, self._probe_token
            return self._cap(requested), None

    def observe(self, requested: str, granted: str, final: str,
                token: Optional[object] = None) -> None:
        """Fold one finished request in.  ``final`` is the Explorer's
        engine after the sweep; ``final != granted`` means it demoted.
        ``token`` is whatever :meth:`admit` returned for this request —
        only the holder of the live probe token resolves the half-open
        state; concurrent or stale requests can never close the breaker
        on the probe's behalf."""
        demoted = final != granted
        with self._lock:
            if token is not None and token is self._probe_token:
                self._probe_token = None
                if demoted:
                    self.state = "open"
                    self._opened_at = time.monotonic()
                    self.pinned = self._cap(final)
                    self.trips += 1
                else:
                    self.state = "closed"
                    self.pinned = None
                    self._consecutive = 0
                return
            if self.state != "closed":
                return
            if demoted:
                self._consecutive += 1
                self.pinned = final if self.pinned is None \
                    else min(self.pinned, final, key=self._rank)
                if self._consecutive >= self.threshold:
                    self.state = "open"
                    self._opened_at = time.monotonic()
                    self.trips += 1
            elif granted != "reference":
                # a clean run of a demotable engine: the chain is healthy
                self._consecutive = 0
                self.pinned = None

    def release_probe(self, token: Optional[object]) -> None:
        """The probe request died without producing a final engine
        (bad input after admission, a coalescer fault, an unexpected
        500).  Treat it as a failed probe — re-open and restart the
        cool-down — instead of leaking the probe slot and wedging the
        breaker half-open (capped) forever.  A ``None`` or stale token
        is a no-op, so non-probe failures may call this untested."""
        with self._lock:
            if token is None or token is not self._probe_token:
                return
            self._probe_token = None
            self.state = "open"
            self._opened_at = time.monotonic()
            self.trips += 1

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state, "pinned": self.pinned,
                    "trips": self.trips,
                    "consecutive_demotions": self._consecutive,
                    "probe_in_flight": self._probe_token is not None}


class SweepService:
    """The engine room behind the HTTP layer — fully testable without a
    socket: :meth:`submit` takes a raw request body and returns
    ``(status, document)``.

    One service owns the warm state every request shares: the
    :class:`ReplayLibrary` (all public methods lock-protected), the
    on-disk order/graph/sim store, the :class:`Coalescer` and the
    :class:`CircuitBreaker`.  Explorers are per-request (their sweep
    state — deadlines, respawn budgets, memo namespaces — is per-call by
    design) but plug into the shared library, disk dir and coalescer, so
    a warm server answers repeat questions at cache speed.

    ``device`` (default :func:`repro_torch.default_device`, the card) is
    where torch-engine requests run; it is handed only to Explorers
    granted ``torch``, so a request the breaker capped to ``batch`` runs
    on the host as any other ``batch`` request.
    """

    def __init__(self, *, cache_dir: Optional[str] = None,
                 processes: int = 0,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 max_concurrent: int = DEFAULT_MAX_CONCURRENT,
                 coalesce_window: float = DEFAULT_WINDOW_S,
                 breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
                 breaker_reset_s: float = DEFAULT_BREAKER_RESET_S,
                 device: Optional[str] = None):
        if queue_limit < 0:
            raise ValueError(f"queue_limit must be >= 0: {queue_limit!r}")
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1: "
                             f"{max_concurrent!r}")
        self.cache_dir = cache_dir
        self.device = default_device() if device is None else str(device)
        self.processes = int(processes)
        self.queue_limit = int(queue_limit)
        self.max_concurrent = int(max_concurrent)
        self.library = ReplayLibrary()
        self._disk = DiskCache(cache_dir) if cache_dir is not None else None
        self.breaker = CircuitBreaker(breaker_threshold, breaker_reset_s)
        self._cond = threading.Condition()
        self.waiting = 0
        self.running = 0
        self.draining = False
        self.started = time.monotonic()
        self.done = 0
        self.shed = 0               # 429s
        self.errors = 0             # 4xx/5xx besides shed
        self.fault_totals: Dict[str, int] = {k: 0 for k in FAULT_KEYS}
        self.retire_totals: Dict[str, int] = {k: 0 for k in RETIRE_KEYS}
        self._ema_sweep_s = 1.0     # Retry-After estimate
        # the coalescer gates its merge window on the running count: solo
        # requests skip the latency floor, and a leader holding every
        # in-flight request closes early instead of sleeping it out
        self.coalescer = Coalescer(
            coalesce_window, library=self.library,
            load_fn=self._running)
        # torch sweeps take the engine one at a time: threads that
        # interleave step loops hand the interpreter lock over at every
        # launch (tools/sweepd_concurrency.py), and every replay of the
        # step loop's captured graphs (shared by the requests' Explorers
        # through the compile cache) stays under this lock.  An admitted
        # torch request waits here within its budget; the wait counts as
        # queue time.
        self._torch_lock = threading.Lock()

    def _running(self) -> int:
        with self._cond:
            return self.running

    # ------------------------------------------------------------ submit
    def submit(self, body: Any) -> Tuple[int, Dict[str, Any]]:
        """One request through admission + sweep; returns
        ``(http_status, response_document)`` and never raises."""
        t0 = time.perf_counter()
        try:
            req = SweepRequest.from_json(body)
        except ProtocolError as exc:
            with self._cond:
                self.errors += 1
            return 400, error_doc(str(exc))

        with self._cond:
            if self.draining:
                return 503, error_doc("draining: not admitting requests")
            # the queue bound only applies when no run slot is free: an
            # idle server always admits (queue_limit=0 means "never
            # wait", not "never serve")
            if self.running >= self.max_concurrent \
                    and self.waiting >= self.queue_limit:
                self.shed += 1
                retry = round(max(0.5, self._ema_sweep_s), 3)
                return 429, error_doc(
                    "queue full: load shed", retry_after_s=retry)
            self.waiting += 1
            try:
                while self.running >= self.max_concurrent \
                        and not self.draining:
                    left = req.budget_s - (time.perf_counter() - t0)
                    if left <= 0:
                        queue_s = time.perf_counter() - t0
                        self.errors += 1
                        return 504, error_doc(
                            "budget expired while queued",
                            timings=timings_block(queue_s, 0.0, queue_s))
                    self._cond.wait(timeout=left)
                if self.draining:
                    return 503, error_doc(
                        "draining: not admitting requests")
                self.running += 1
            finally:
                self.waiting -= 1

        queue_s = time.perf_counter() - t0
        status, doc = 500, error_doc("internal error")
        try:
            status, doc = self._run(req, queue_s, t0)
        except ProtocolError as exc:
            status, doc = 400, error_doc(str(exc))
        except Exception as exc:    # noqa: BLE001 — the server never dies
            status, doc = 500, error_doc(
                f"internal error: {type(exc).__name__}: {exc}")
        finally:
            with self._cond:
                self.running -= 1
                self.done += 1
                if status != 200:
                    self.errors += 1
                self._cond.notify_all()
        return status, doc

    def _run(self, req: SweepRequest, queue_s: float,
             t0: float) -> Tuple[int, Dict[str, Any]]:
        remaining = req.budget_s - queue_s
        if remaining <= 0:
            return 504, error_doc(
                "budget expired while queued",
                timings=timings_block(queue_s, 0.0, queue_s))
        # materialize before touching the breaker: a malformed request
        # must answer 400 without ever consuming the half-open probe
        trace, reports, cands = req.materialize()
        granted, probe = self.breaker.admit(req.engine)
        if granted == "torch":
            if not self._torch_lock.acquire(timeout=remaining):
                self.breaker.release_probe(probe)
                queue_s = time.perf_counter() - t0
                return 504, error_doc(
                    "budget expired waiting for the torch engine",
                    timings=timings_block(queue_s, 0.0, queue_s))
            queue_s = time.perf_counter() - t0
            remaining = req.budget_s - queue_s

        try:
            # engine-conditional plumbing: torch never fans out to
            # processes and alone takes the server's device, the
            # reference engine takes no disk cache, and the coalescer is
            # exact-batch + in-process only (see repro_torch.serve.coalesce)
            procs = self.processes if granted in ("fast", "batch") else 0
            cache_dir = self.cache_dir if granted != "reference" else None
            device = self.device if granted == "torch" else None
            runner = None
            if granted == "batch" and procs == 0:
                policy = req.policy
                runner = (lambda fg, systems, deadline_left:
                          self.coalescer.run_family(fg, systems, policy,
                                                    deadline_left))
            # PPA mode rides the same machinery: the spec library is
            # always derived server-side from this request's reports
            # (never supplied over the wire), and coalescing stays safe
            # because family evaluation exchanges raw SimResults — the
            # PPA annotation happens post-sim in this Explorer
            ex = Explorer(trace, reports, policy=req.policy,
                          engine=granted, device=device, processes=procs,
                          cache_dir=cache_dir,
                          order_library=self.library,
                          candidate_timeout=req.candidate_timeout_s,
                          family_runner=runner,
                          objectives=req.objectives, budgets=req.budgets)
            with self.coalescer.context() as co:
                result = ex.explore(cands, top_k=req.top_k,
                                    prune=req.prune, deadline_s=remaining)
        except BaseException:
            # a probe that dies mid-flight re-opens the breaker rather
            # than leaking the probe slot (no-op for non-probe requests)
            self.breaker.release_probe(probe)
            raise
        finally:
            if granted == "torch":
                self._torch_lock.release()
        self.breaker.observe(req.engine, granted, ex.engine, probe)

        ex_faults = ex.stats.as_dict()
        with self._cond:
            for k in FAULT_KEYS:
                self.fault_totals[k] += int(ex_faults.get(k, 0))
            for k in RETIRE_KEYS:
                self.retire_totals[k] += int(ex_faults.get(k, 0))
            self._ema_sweep_s = (0.7 * self._ema_sweep_s
                                 + 0.3 * result.wall_seconds)

        doc = sweep_doc(req.trace, req.engine, ex, result, len(cands),
                        req.top_k)
        doc["engine_granted"] = granted
        doc["timings"] = timings_block(
            queue_s, result.wall_seconds, time.perf_counter() - t0)
        doc["coalesce"] = co
        doc["breaker"] = self.breaker.as_dict()
        return 200, doc

    # ------------------------------------------------------------- drain
    def begin_drain(self) -> None:
        with self._cond:
            self.draining = True
            self._cond.notify_all()

    def drained(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request finished (True) or the
        timeout expired with work still in flight (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.running > 0:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return True

    def flush_orders(self) -> int:
        """Persist dirty dispatch orders for every policy; the drain
        path's last act (per-request Explorers flush after each sweep,
        so this only catches orders dirtied since — e.g. by a request
        that was granted no disk cache)."""
        if self._disk is None:
            return 0
        n = 0
        for policy in POLICIES:
            for token in self.library.take_dirty(policy):
                export = self.library.export(token, policy)
                if export:
                    self._disk.put(orders_disk_text(token, policy), export)
                    n += 1
        return n

    # ---------------------------------------------------------- health
    def health_doc(self) -> Dict[str, Any]:
        with self._cond:
            doc = {
                "status": "draining" if self.draining else "ok",
                "uptime_s": round(time.monotonic() - self.started, 3),
                "requests": {"done": self.done, "running": self.running,
                             "waiting": self.waiting, "shed": self.shed,
                             "errors": self.errors},
                "faults": dict(self.fault_totals),
                "retire": dict(self.retire_totals),
            }
        doc["breaker"] = self.breaker.as_dict()
        doc["coalesce"] = self.coalescer.stats.as_dict()
        doc["replay"] = self.coalescer.replay_stats()
        doc["library"] = self.library.counts()
        return doc

    def ready(self) -> bool:
        with self._cond:
            return not self.draining \
                and (self.running < self.max_concurrent
                     or self.waiting < self.queue_limit)


class _Handler(BaseHTTPRequestHandler):
    server_version = "sweepd/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):   # noqa: A002 — stdlib name
        pass                                 # telemetry goes via /healthz

    def _send(self, status: int, doc: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:
        if self.path != "/sweep":
            self._send(404, error_doc(f"no such endpoint: {self.path}"))
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        status, doc = self.server.service.submit(self.rfile.read(n))
        headers = {}
        if status == 429:
            headers["Retry-After"] = str(
                int(math.ceil(doc.get("retry_after_s", 1.0))))
        self._send(status, doc, headers)

    def do_GET(self) -> None:
        svc = self.server.service
        if self.path == "/healthz":
            self._send(200, svc.health_doc())
        elif self.path == "/readyz":
            if svc.ready():
                self._send(200, {"ready": True})
            else:
                self._send(503, {"ready": False,
                                 "draining": svc.draining})
        else:
            self._send(404, error_doc(f"no such endpoint: {self.path}"))


class SweepServer(ThreadingHTTPServer):
    """Threaded HTTP front.  ``block_on_close`` makes ``server_close()``
    join the handler threads, so a cleanly drained server's in-flight
    responses are always fully written before exit.  When the drain
    *times out* (``--drain-timeout``) the handlers are instead abandoned
    via :meth:`abandon_in_flight` — ``server_close()`` skips the join
    and, the threads being daemonic, they cannot hold up interpreter
    exit either: the drain timeout is a hard deadline."""

    daemon_threads = True
    block_on_close = True
    allow_reuse_address = True

    def __init__(self, addr: Tuple[str, int], service: SweepService):
        super().__init__(addr, _Handler)
        self.service = service
        self.abandoned = False

    def abandon_in_flight(self) -> None:
        """Hard-deadline drain: give up on wedged in-flight handlers."""
        self.abandoned = True

    def server_close(self) -> None:
        if self.abandoned:
            HTTPServer.server_close(self)   # skip ThreadingMixIn's join
        else:
            super().server_close()


def serve(service: SweepService, host: str = "127.0.0.1",
          port: int = 0) -> SweepServer:
    """Bind (port 0 picks a free one) — caller runs serve_forever."""
    return SweepServer((host, port), service)


# ---------------------------------------------------------------------------
# CLI entry points (dispatched from ``python -m repro_torch.explore``)
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore serve",
        description="Long-lived sweep server (HTTP/JSON).")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="0 picks a free port (default %(default)s)")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=default_device(),
                    help="device of torch-engine requests (default "
                         "%(default)s; never replaced by another)")
    ap.add_argument("--processes", type=int, default=0, metavar="N",
                    help="worker processes per sweep (exact engines)")
    ap.add_argument("--cache-dir", metavar="DIR",
                    help="persistent graph/sim/order store")
    ap.add_argument("--queue-limit", type=int,
                    default=DEFAULT_QUEUE_LIMIT, metavar="N",
                    help="waiting requests before load shedding, applied "
                         "only while every run slot is busy "
                         "(default %(default)s)")
    ap.add_argument("--max-concurrent", type=int,
                    default=DEFAULT_MAX_CONCURRENT, metavar="N",
                    help="sweeps in flight at once (default %(default)s)")
    ap.add_argument("--coalesce-window", type=float,
                    default=DEFAULT_WINDOW_S, metavar="S",
                    help="batch-merge window under concurrent load "
                         "(default %(default)s)")
    ap.add_argument("--breaker-threshold", type=int,
                    default=DEFAULT_BREAKER_THRESHOLD, metavar="N")
    ap.add_argument("--breaker-reset", type=float,
                    default=DEFAULT_BREAKER_RESET_S, metavar="S")
    ap.add_argument("--drain-timeout", type=float,
                    default=DEFAULT_DRAIN_TIMEOUT_S, metavar="S",
                    help="max seconds to wait for in-flight sweeps on "
                         "SIGTERM (default %(default)s)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        try:
            require_cuda()
        except DeviceError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2

    # a threaded parent must never fork: pools must come up via
    # forkserver, CUDA initialised or not
    os.environ.setdefault("REPRO_POOL_START", "forkserver")

    service = SweepService(
        cache_dir=args.cache_dir, processes=args.processes,
        queue_limit=args.queue_limit, max_concurrent=args.max_concurrent,
        coalesce_window=args.coalesce_window,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset, device=args.device)
    httpd = serve(service, args.host, args.port)

    def _drain_then_stop() -> None:
        service.begin_drain()
        clean = service.drained(args.drain_timeout)
        if not clean:
            # the timeout is a hard deadline: abandon wedged handlers so
            # server_close() cannot re-introduce an unbounded join
            httpd.abandon_in_flight()
            print(f"sweepd: drain timed out after "
                  f"{args.drain_timeout}s with sweeps still in flight — "
                  f"abandoning them", file=sys.stderr, flush=True)
        flushed = service.flush_orders()
        print(f"sweepd: drained ({service.done} request(s) served, "
              f"{flushed} order payload(s) flushed)", file=sys.stderr,
              flush=True)
        httpd.shutdown()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal signature
        threading.Thread(target=_drain_then_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    host, port = httpd.server_address[:2]
    print(f"sweepd listening on http://{host}:{port}", file=sys.stderr,
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()    # joins in-flight handlers unless abandoned
        # catch orders dirtied between the drain handler's early flush
        # and the last handler thread finishing (a post-timeout abandoned
        # sweep may still lose its orders — that is the hard deadline)
        service.flush_orders()
    return 0


def client_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.explore client`` — one sweep against a
    server.  A trace file (``Trace.save`` JSONL) is read here and sent
    inline with its ``--reports``, since the server takes no paths."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore client",
        description="Submit one sweep request to a running sweepd.")
    ap.add_argument("--url", default="http://127.0.0.1:8787",
                    help="server base URL (default %(default)s)")
    ap.add_argument("trace", help="synth:N, or a Trace JSONL (Trace.save) "
                                  "sent inline")
    ap.add_argument("--reports", metavar="PATH",
                    help="JSON list of kernel cost reports, sent inline "
                         "(required for a file trace)")
    ap.add_argument("--engine", choices=ENGINE_NAMES, default="torch",
                    help="evaluation engine (default %(default)s, on the "
                         "server's device)")
    ap.add_argument("--policy", choices=POLICIES, default="availability")
    ap.add_argument("--accs", default="1-8", metavar="SPEC")
    ap.add_argument("--no-smp", action="store_true")
    ap.add_argument("--top-k", type=int, default=5, metavar="K")
    ap.add_argument("--prune", action="store_true",
                    help="branch-and-bound pruning (composes with the "
                         "batch/torch lockstep engines)")
    ap.add_argument("--budget", type=float, default=120.0, metavar="S",
                    help="whole-request latency budget "
                         "(default %(default)s)")
    ap.add_argument("--objectives", metavar="AXES", default=None,
                    help="comma-separated PPA objective axes — "
                         "Pareto-frontier output")
    ap.add_argument("--ppa-budget", metavar="AXIS=VALUE", action="append",
                    default=None, dest="ppa_budgets",
                    help="PPA budget bound, repeatable (distinct from the "
                         "latency --budget)")
    ap.add_argument("--health", action="store_true",
                    help="print /healthz instead of sweeping")
    args = ap.parse_args(argv)

    base = args.url.rstrip("/")
    if args.health:
        status, doc = get_json(base + "/healthz")
    else:
        body = {
            "trace": args.trace, "engine": args.engine,
            "policy": args.policy, "accs": args.accs,
            "smp": not args.no_smp, "top_k": args.top_k,
            "prune": args.prune, "budget_s": args.budget,
        }
        try:
            objectives = parse_objectives(args.objectives)
            budgets = parse_budget_args(args.ppa_budgets)
            if not args.trace.startswith("synth:"):
                if not args.reports:
                    raise ValueError("--reports is required for a file "
                                     "trace")
                body["trace"] = "inline"
                body["events"] = [json.loads(e.to_json()) for e
                                  in Trace.load(args.trace).events]
            if args.reports:
                with open(args.reports) as f:
                    body["reports"] = json.load(f)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        if objectives is not None:
            body["objectives"] = objectives
        if budgets is not None:
            body["budgets"] = budgets
        status, doc = post_json(base + "/sweep", body,
                                timeout=args.budget + 30.0)
    print(json.dumps(doc, indent=2))
    if status != 200:
        print(f"error: HTTP {status}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
