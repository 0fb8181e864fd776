"""Eigensolver-as-a-service: async scheduler with continuous batching.

The reference's ``repro/serving/scheduler.py``.  The paper's economics, one
expensive per-matrix setup (format conversion, tuning) amortized over a
stream of Top-K queries, become a serving problem once queries arrive
asynchronously: who holds the prepared sessions, which queued queries may
share one Lanczos sweep, and what happens when the queue outruns the solver.

* ``EigenScheduler`` admits :class:`~repro_torch.api.EigQuery` requests
  against a bounded pool of resident :class:`~repro_torch.api.EigenSession`\\ s
  and resolves each request's :class:`QueryHandle` future with its own
  :class:`~repro_torch.api.EigenResult`.
* **Continuous batching**: a dispatch thread pulls the oldest request, then
  holds the batch open for an *admission window*, coalescing every queued
  request with the same session and the same
  :meth:`EigenSession.group_key`, the predicate ``eigsh_many`` groups by, so
  a coalesced batch is served by ONE shared sweep and each answer is what
  the batched API returns.  ``policy="auto"`` queries never coalesce.
* **SLOs**: deadlines shrink the admission window and expire queued
  requests with :class:`DeadlineExceededError`; queued requests can be
  cancelled; a bounded queue rejects overload with :class:`QueueFullError`.
* **Warm restarts**: with a :class:`~repro_torch.serving.store.SessionStore`
  attached, ``add_matrix`` restores persisted device layouts, tiles and
  iteration plans keyed by matrix fingerprint (zero conversions, zero tuner
  probes) and persists cold-built sessions for the next process.
* **Metrics**: queue depth, batch occupancy, coalesce rate, warm-start
  counters, p50/p99 latency via :meth:`EigenScheduler.stats`.
* **Fault tolerance**: per-request retries with exponential backoff and
  jitter (transient failures only), a per-matrix circuit breaker, a
  dispatch-loop guard that fails a group typed instead of the thread, and a
  watchdog that fails every stranded request with
  :class:`SchedulerCrashedError` when the dispatch thread dies.

On the card, the dispatch thread runs each group under
``torch.cuda.device(session.device)`` (the current device and stream are
per thread), and a future resolves only after its group's results are
complete on the card.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional

import torch

from ..api.frontend import SolverConfig
from ..api.result import EigenResult, with_queue_time
from ..api.session import EigenSession, _as_query
from ..testing import faults as _faults
from .metrics import ServerStats, ServingMetrics
from .store import SessionStore

__all__ = [
    "EigenScheduler",
    "SchedulerConfig",
    "QueryHandle",
    "ServingError",
    "QueueFullError",
    "DeadlineExceededError",
    "QueryCancelledError",
    "UnknownMatrixError",
    "SessionUnhealthyError",
    "SchedulerCrashedError",
]


class ServingError(RuntimeError):
    """Base class of every typed serving-layer failure."""


class QueueFullError(ServingError):
    """Submission rejected: the bounded request queue is at capacity."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before its solve was dispatched."""


class QueryCancelledError(ServingError):
    """The request was cancelled while still queued."""


class UnknownMatrixError(ServingError):
    """The named matrix is not resident in the scheduler's session pool."""


class SessionUnhealthyError(ServingError):
    """The matrix's circuit breaker is open: its last
    ``SchedulerConfig.breaker_threshold`` dispatches all failed, so
    submissions fail fast instead of queueing onto a known-bad session.
    The breaker half-opens after ``breaker_cooldown_s`` — one probe query
    is admitted; success closes it, failure re-opens it."""


class SchedulerCrashedError(ServingError):
    """The dispatch thread died; the watchdog failed every pending request
    with this instead of leaving their futures hanging.  ``start()`` the
    scheduler again to recover."""


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Serving knobs.

    Attributes:
      max_queue: bounded-queue backpressure limit — submissions beyond this
        many pending requests raise :class:`QueueFullError`.
      admission_window_s: how long the dispatcher holds a batch open for
        more compatible queries after pulling its first member.  0 disables
        waiting (still coalesces whatever is already queued).
      max_group: most queries one coalesced ``eigsh_many`` dispatch serves.
      max_sessions: bounded session pool — adding a matrix beyond this
        evicts the least-recently-used resident session (persisted to the
        store first, when one is attached).
      max_retries: per-request retry budget for *transient* dispatch
        failures (numerical breakdown, OOM, I/O, injected faults — never
        validation errors).  0 (default) fails on first error, matching the
        pre-retry behavior exactly.
      retry_backoff_s: base delay before a retried request becomes eligible
        again; attempt ``i`` waits ``retry_backoff_s * 2**(i-1)`` scaled by
        up to ``1 + retry_jitter`` of random jitter (decorrelates retry
        storms after a shared-cause failure).
      retry_jitter: jitter fraction on the backoff (0 = deterministic).
      breaker_threshold: consecutive dispatch failures on one matrix that
        open its circuit breaker (submissions then raise
        :class:`SessionUnhealthyError` until a cooldown probe succeeds).
        0 (default) disables the breaker.
      breaker_cooldown_s: how long an open breaker rejects before it
        half-opens and admits one probe query.
      watchdog_interval_s: poll period of the dispatch-thread watchdog.
    """

    max_queue: int = 256
    admission_window_s: float = 2e-3
    max_group: int = 32
    max_sessions: int = 8
    max_retries: int = 0
    retry_backoff_s: float = 0.05
    retry_jitter: float = 0.2
    breaker_threshold: int = 0
    breaker_cooldown_s: float = 5.0
    watchdog_interval_s: float = 0.5


class QueryHandle:
    """Future for one submitted query.

    ``result(timeout)`` blocks until the solve lands and returns the
    per-query :class:`~repro_torch.api.EigenResult` (with the ``queue_s`` /
    ``e2e_s`` timing split stamped in), or raises the typed error the
    request died with.  ``cancel()`` withdraws a still-queued request.
    """

    # These fields are mutated only while holding the named lock (dispatch
    # and cancel race on them).
    _GUARDED_BY = {"_cancelled": "_lock", "_started": "_lock"}

    def __init__(self, matrix: str, query, group_key: Optional[tuple], deadline: Optional[float]):
        self.matrix = matrix
        self.query = query
        self.group_key = group_key
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.submit_t = time.monotonic()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[EigenResult] = None
        self._exception: Optional[BaseException] = None
        self._cancelled = False
        self._started = False
        self.attempts = 0  # dispatch attempts so far (retry accounting)
        self.not_before = 0.0  # monotonic time before which a retry must wait

    # -- caller side ------------------------------------------------------

    def cancel(self) -> bool:
        """Withdraw the request if it has not been dispatched; returns
        whether the cancellation took effect."""
        with self._lock:
            if self._started or self._event.is_set():
                return False
            self._cancelled = True
            return True

    def cancelled(self) -> bool:
        return self._cancelled

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> EigenResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query against {self.matrix!r} not done after {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query against {self.matrix!r} not done after {timeout}s")
        return self._exception

    # -- scheduler side ---------------------------------------------------

    def _start(self) -> bool:
        """Mark dispatched; False when a cancel won the race."""
        with self._lock:
            if self._cancelled:
                return False
            self._started = True
            return True

    def _set_result(self, res: EigenResult) -> None:
        self._result = res
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()

    def _reset_for_retry(self) -> None:
        """Back onto the queue after a retryable failure: un-mark dispatched
        so cancel() works again while the retry waits out its backoff."""
        with self._lock:
            self._started = False


class EigenScheduler:
    """Async eigensolver server over a bounded pool of prepared sessions.

    ::

        store = SessionStore(root)                  # optional persistence
        with EigenScheduler(store=store) as sched:
            key = sched.add_matrix(csr)             # warm from store, or build
            h = sched.submit(key, k=8, num_iters=32, deadline_s=0.5)
            res = h.result()                        # EigenResult future

    One dispatch thread executes coalesced ``eigsh_many`` groups; distinct
    sessions stay independent (the session layer serializes per-session
    query batches internally).  ``start=False`` constructs the scheduler
    paused — submissions queue but nothing dispatches until :meth:`start` —
    which is also the deterministic way to test backpressure and deadlines.
    """

    # Everything the dispatch thread and submitters share is guarded by the
    # scheduler condition variable (``_cv`` wraps ``_lock``);
    # ``_thread``/``_watchdog`` are lifecycle handles owned by the
    # start()/close() callers and deliberately absent.
    _GUARDED_BY = {
        "_sessions": "_cv",
        "_queue": "_cv",
        "_running": "_cv",
        "_closed": "_cv",
        "_crashed": "_cv",
        "_inflight": "_cv",
        "_breakers": "_cv",
    }

    def __init__(
        self,
        config: Optional[SchedulerConfig] = None,
        *,
        store: Optional[SessionStore] = None,
        start: bool = True,
    ):
        self.config = config or SchedulerConfig()
        self.store = store
        self.metrics = ServingMetrics()
        self._sessions: "OrderedDict[str, EigenSession]" = OrderedDict()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: Deque[QueryHandle] = deque()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._running = False
        self._closed = False
        self._crashed = False
        self._inflight: List[QueryHandle] = []  # group the dispatch thread holds
        self._breakers: Dict[str, dict] = {}  # matrix -> breaker state
        if start:
            self.start()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "EigenScheduler":
        with self._cv:
            if self._closed:
                raise ServingError("scheduler is closed")
            if self._running:
                return self
            self._running = True
            self._crashed = False
            # ONE dispatch thread runs every solve: the kernels' ``launches``
            # counters are plain module ints, exact because no two solves
            # launch at once.
            self._thread = threading.Thread(
                target=self._loop, name="eigen-scheduler", daemon=True
            )
            self._thread.start()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                args=(self._thread,),
                name="eigen-scheduler-watchdog",
                daemon=True,
            )
            self._watchdog.start()
        return self

    def close(self, *, persist: bool = True, timeout: float = 30.0) -> None:
        """Stop dispatching, fail leftover queued requests with
        :class:`ServingError`, and (by default) persist every resident
        session to the attached store."""
        with self._cv:
            self._closed = True
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._watchdog is not None:
            # The watchdog exits on its next poll once _running is False.
            self._watchdog.join(self.config.watchdog_interval_s * 4)
            self._watchdog = None
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
        for h in leftovers:
            h._set_exception(ServingError("scheduler closed before dispatch"))
        if persist:
            self.persist()

    def persist(self) -> int:
        """Save every resident session's built plans to the store (no-op
        without one); returns how many sessions were written."""
        if self.store is None:
            return 0
        with self._cv:
            sessions = list(self._sessions.values())
        return sum(1 for s in sessions if self.store.save(s) is not None)

    def __enter__(self) -> "EigenScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- admin plane

    def add_matrix(
        self,
        A,
        *,
        name: Optional[str] = None,
        config: Optional[SolverConfig] = None,
        n: Optional[int] = None,
    ) -> str:
        """Make a matrix resident: prepare (or warm-restore) its session and
        return the key ``submit`` addresses it by (``name``, defaulting to
        the matrix fingerprint).  With a store attached, a persisted entry
        for (matrix, layout) warms the session with zero conversions; a cold
        build is persisted for the next process.  Beyond
        ``config.max_sessions`` residents, the LRU session is evicted."""
        session = EigenSession(A, config, n=n)
        imported = self.store.load_into(session) if self.store is not None else 0
        if imported > 0:
            self.metrics.inc("warm_starts")
        else:
            session.warmup()
            self.metrics.inc("cold_builds")
            if self.store is not None:
                self.store.save(session)
        key = name or session.ensure_fingerprint()
        if key is None:
            raise ServingError(
                "matrix has no content fingerprint (matrix-free input?); pass name="
            )
        evicted: List[EigenSession] = []
        with self._cv:
            self._sessions[key] = session
            self._sessions.move_to_end(key)
            while len(self._sessions) > self.config.max_sessions:
                _, old = self._sessions.popitem(last=False)
                evicted.append(old)
        for old in evicted:  # persist outside the lock: saves can be slow
            if self.store is not None:
                self.store.save(old)
        return key

    def session(self, matrix: str) -> EigenSession:
        with self._cv:
            sess = self._sessions.get(matrix)
        if sess is None:
            raise UnknownMatrixError(f"matrix {matrix!r} is not resident; add_matrix first")
        return sess

    # --------------------------------------------------------- query plane

    def submit(
        self,
        matrix: str,
        query: Any = None,
        *,
        deadline_s: Optional[float] = None,
        **fields,
    ) -> QueryHandle:
        """Queue one query against a resident matrix; returns its future.

        ``query`` is anything ``eigsh_many`` accepts (an ``EigQuery``, a
        dict, a bare ``k``); alternatively pass the fields as keywords
        (``submit(key, k=8, policy="FDF")``).  Validation runs *here* — an
        infeasible query (bad ``k``/``num_iters``) raises ``ValueError``
        synchronously, never poisoning a batch.  ``deadline_s`` (relative
        seconds) bounds queue wait: the dispatcher never holds a batch open
        past it, and expires the request with
        :class:`DeadlineExceededError` if the solve cannot start in time.
        """
        sess = self.session(matrix)  # raises UnknownMatrixError
        q = _as_query(query if query is not None else fields)
        gkey = sess.group_key(q)  # validates; raises ValueError on bad queries
        deadline = time.monotonic() + float(deadline_s) if deadline_s is not None else None
        h = QueryHandle(matrix, q, gkey, deadline)
        with self._cv:
            if self._closed:
                raise ServingError("scheduler is closed")
            if self._crashed:
                raise SchedulerCrashedError(
                    "scheduler dispatch thread died; start() it again to recover"
                )
            self._breaker_admit_locked(matrix)
            if len(self._queue) >= self.config.max_queue:
                self.metrics.inc("rejected_full")
                raise QueueFullError(
                    f"request queue at capacity ({self.config.max_queue} pending); "
                    "retry with backoff or raise SchedulerConfig.max_queue"
                )
            self._queue.append(h)
            self._sessions.move_to_end(matrix)  # LRU touch
            self.metrics.inc("submitted")
            self._cv.notify_all()
        return h

    def stats(self) -> ServerStats:
        """Point-in-time :class:`~repro_torch.serving.metrics.ServerStats`."""
        with self._cv:
            depth = len(self._queue)
            nsess = len(self._sessions)
        return self.metrics.snapshot(queue_depth=depth, sessions=nsess)

    # ------------------------------------------------------ circuit breaker

    def _breaker_admit_locked(self, matrix: str) -> None:
        """Fail-fast gate at submission (caller holds the lock): raises
        :class:`SessionUnhealthyError` while the matrix's breaker is open.
        After the cooldown the breaker half-opens — ONE probe submission
        passes; further submissions keep failing until the probe's dispatch
        outcome closes (success) or re-opens (failure) the breaker."""
        if self.config.breaker_threshold <= 0:
            return
        b = self._breakers.get(matrix)
        if b is None or b["state"] == "closed":
            return
        now = time.monotonic()
        if b["state"] == "open" and now >= b["open_until"]:
            b["state"] = "half"  # this submission is the probe
            return
        self.metrics.inc("rejected_breaker")
        raise SessionUnhealthyError(
            f"matrix {matrix!r} breaker is {b['state']} after "
            f"{b['failures']} consecutive dispatch failure(s); "
            f"retry after the cooldown ({self.config.breaker_cooldown_s}s)"
        )

    def _breaker_record(self, matrix: str, ok: bool) -> None:
        """Fold one dispatch outcome into the matrix's breaker state."""
        if self.config.breaker_threshold <= 0:
            return
        with self._cv:
            b = self._breakers.setdefault(
                matrix, {"state": "closed", "failures": 0, "open_until": 0.0}
            )
            if ok:
                b["state"] = "closed"
                b["failures"] = 0
                return
            b["failures"] += 1
            tripping = (
                b["failures"] >= self.config.breaker_threshold
                or b["state"] == "half"  # the probe itself failed
            )
            if tripping and b["state"] != "open":
                b["state"] = "open"
                b["open_until"] = time.monotonic() + self.config.breaker_cooldown_s
                self.metrics.inc("breaker_trips")
            elif b["state"] == "open":
                b["open_until"] = time.monotonic() + self.config.breaker_cooldown_s

    def breaker_state(self, matrix: str) -> str:
        """Current breaker state for a matrix: "closed" | "open" | "half"."""
        with self._cv:
            b = self._breakers.get(matrix)
            return b["state"] if b else "closed"

    # ------------------------------------------------------- dispatch loop

    def _resolve_dead(self, h: QueryHandle, now: float) -> bool:
        """Terminally resolve a cancelled/expired request; True if it died."""
        if h.cancelled():
            self.metrics.inc("cancelled")
            h._set_exception(QueryCancelledError(f"query against {h.matrix!r} cancelled"))
            return True
        if h.deadline is not None and now > h.deadline:
            self.metrics.inc("rejected_deadline")
            h._set_exception(
                DeadlineExceededError(
                    f"deadline exceeded before dispatch "
                    f"(waited {now - h.submit_t:.3f}s in queue)"
                )
            )
            return True
        return False

    def _take_compatible(self, seed: QueryHandle, room: int) -> List[QueryHandle]:
        """Pull every queued request coalescible with ``seed`` (same matrix,
        same non-None group key), resolving dead ones along the way.  Caller
        holds the lock."""
        if seed.group_key is None or room <= 0:
            return []
        now = time.monotonic()
        taken: List[QueryHandle] = []
        keep: Deque[QueryHandle] = deque()
        while self._queue:
            h = self._queue.popleft()
            if self._resolve_dead(h, now):
                continue
            if (
                len(taken) < room
                and h.matrix == seed.matrix
                and h.group_key == seed.group_key
                and h.not_before <= now  # retries wait out their backoff
            ):
                taken.append(h)
            else:
                keep.append(h)
        self._queue.extend(keep)
        return taken

    def _next_group(self) -> Optional[List[QueryHandle]]:
        """Block until a batch is ready: pop the oldest live request, then
        hold the batch open for the admission window (clipped to the batch's
        earliest deadline), coalescing compatible arrivals."""
        with self._cv:
            seed: Optional[QueryHandle] = None
            while seed is None:
                if not self._running:
                    return None
                now = time.monotonic()
                backing_off: Deque[QueryHandle] = deque()
                while self._queue:
                    h = self._queue.popleft()
                    if self._resolve_dead(h, now):
                        continue
                    if h.not_before > now:
                        backing_off.append(h)  # retry not yet eligible
                        continue
                    seed = h
                    break
                while backing_off:  # restore skipped retries, order kept
                    self._queue.appendleft(backing_off.pop())
                if seed is None:
                    self._cv.wait(timeout=0.1)
            group = [seed]
            window_end = time.monotonic() + self.config.admission_window_s
            if seed.deadline is not None:
                window_end = min(window_end, seed.deadline)
            while len(group) < self.config.max_group:
                taken = self._take_compatible(seed, self.config.max_group - len(group))
                group.extend(taken)
                for h in taken:
                    if h.deadline is not None:
                        # Deadline-aware formation: never idle past the most
                        # urgent member's slack.
                        window_end = min(window_end, h.deadline)
                if seed.group_key is None or len(group) >= self.config.max_group:
                    break
                remaining = window_end - time.monotonic()
                if remaining <= 0 or not self._running:
                    break
                self._cv.wait(timeout=remaining)
            # Last sweep: arrivals during the final wait still make the bus.
            if seed.group_key is not None and len(group) < self.config.max_group:
                group.extend(self._take_compatible(seed, self.config.max_group - len(group)))
        return group

    def _dispatch(self, group: List[QueryHandle]) -> None:
        t_dispatch = time.monotonic()
        live = [h for h in group if not self._resolve_dead(h, t_dispatch) and h._start()]
        if not live:
            return
        with self._cv:
            sess = self._sessions.get(live[0].matrix)
        if sess is None:
            self.metrics.inc("failed", len(live))
            for h in live:
                h._set_exception(
                    UnknownMatrixError(f"matrix {h.matrix!r} was evicted while queued")
                )
            return
        try:
            results = self._solve(sess, [h.query for h in live])
        except Exception as exc:
            self._dispatch_failed(live, exc)
            return
        self._breaker_record(live[0].matrix, ok=True)
        self.metrics.record_group(len(live))
        for h, res in zip(live, results):
            queue_s = t_dispatch - h.submit_t
            res = with_queue_time(res, queue_s)
            self.metrics.record_latency(queue_s, float(res.timings.get("total_s", 0.0)))
            self.metrics.inc("completed")
            h._set_result(res)

    @staticmethod
    def _solve(sess: EigenSession, queries) -> List[EigenResult]:
        """One coalesced ``eigsh_many`` on the session's device.  This is
        not the main thread, so the session's card is made current here;
        the solvers synchronise before they return, and the explicit
        synchronise keeps a resolved future's tensors complete on the card
        whatever path ran."""
        if sess.device.type != "cuda":
            return sess.eigsh_many(queries)
        with torch.cuda.device(sess.device):
            results = sess.eigsh_many(queries)
            torch.cuda.synchronize(sess.device)
        return results

    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        """Is this dispatch failure worth a retry?  Transient solver/runtime
        failures only — a validation error fails the same way every time."""
        from ..core.lanczos import NumericalBreakdown
        from ..testing.faults import InjectedFault

        if isinstance(exc, (ServingError, ValueError, TypeError)):
            return False
        if isinstance(exc, (NumericalBreakdown, OSError, MemoryError, InjectedFault)):
            return True
        return "out of memory" in str(exc).lower()  # torch.cuda.OutOfMemoryError

    def _dispatch_failed(self, live: List[QueryHandle], exc: Exception) -> None:
        """One dispatch blew up: feed the breaker, then split the group into
        requeued retries (budget left, transient failure — exponential
        backoff + jitter decides when each becomes eligible) and terminal
        failures (resolved with the original exception)."""
        self._breaker_record(live[0].matrix, ok=False)
        cfg = self.config
        retryable = cfg.max_retries > 0 and self._retryable(exc)
        retry = [h for h in live if retryable and h.attempts < cfg.max_retries]
        fail = [h for h in live if h not in retry]
        if fail:
            self.metrics.inc("failed", len(fail))
            for h in fail:
                h._set_exception(exc)
        if not retry:
            return
        now = time.monotonic()
        with self._cv:
            for h in retry:
                h.attempts += 1
                backoff = cfg.retry_backoff_s * (2.0 ** (h.attempts - 1))
                backoff *= 1.0 + max(0.0, cfg.retry_jitter) * random.random()
                h.not_before = now + backoff
                h._reset_for_retry()
                self._queue.append(h)
            self.metrics.inc("retries", len(retry))
            self._cv.notify_all()

    def _loop(self) -> None:
        # Guarded loop: ANY exception a dispatch leaks is contained here —
        # the group fails typed, the thread survives, the next group runs.
        # Injected
        # SchedulerThreadDeath derives from BaseException on purpose: it
        # escapes the guard and genuinely kills the thread, which is the
        # watchdog's test surface.
        while True:
            group = self._next_group()
            if group is None:
                return
            with self._cv:
                self._inflight = group
            try:
                _faults.check_scheduler()
                self._dispatch(group)
            except Exception as exc:
                self.metrics.inc("dispatch_errors")
                pending = [h for h in group if not h.done()]
                if pending:
                    self.metrics.inc("failed", len(pending))
                    err = ServingError(
                        f"internal dispatch failure: {type(exc).__name__}: {exc}"
                    )
                    for h in pending:
                        h._set_exception(err)
            with self._cv:
                self._inflight = []

    # ------------------------------------------------------------ watchdog

    def _watchdog_loop(self, thread: threading.Thread) -> None:
        """Detect dispatch-thread death (anything that escapes the loop
        guard) and fail every stranded request with a typed
        :class:`SchedulerCrashedError` — a crashed scheduler must never
        leave submitters blocked on futures that cannot resolve."""
        while True:
            time.sleep(self.config.watchdog_interval_s)
            with self._cv:
                if not self._running or self._thread is not thread:
                    return  # closed, or superseded by a restart
            if not thread.is_alive():
                self._on_dispatch_death()
                return

    def _on_dispatch_death(self) -> None:
        with self._cv:
            if not self._running:
                return  # normal close raced us
            self._crashed = True
            self._running = False
            stranded = [
                h
                for h in list(self._queue) + list(self._inflight)
                if not h.done()
            ]
            self._queue.clear()
            self._inflight = []
            self.metrics.inc("watchdog_trips")
            if stranded:
                self.metrics.inc("failed", len(stranded))
            self._cv.notify_all()
        err = SchedulerCrashedError(
            "dispatch thread died unexpectedly; this query was failed by the "
            "watchdog (start() the scheduler again to recover)"
        )
        for h in stranded:
            h._set_exception(err)
