"""Serving metrics: counters, latency histograms, and the ``ServerStats``
snapshot the scheduler exposes.

The reference's ``repro/serving/metrics.py`` (plain Python): per-request
latency histograms (queue wait / solve / end-to-end, log-bucketed so p50 and
p99 stay O(1) and allocation-free on the hot path), coalescing counters (how
many sweeps served how many queries) and warm-start counters (sessions
restored from the store vs cold-built).  Submitter threads and the dispatch
thread record concurrently, under locks.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional

__all__ = ["LatencyHistogram", "ServingMetrics", "ServerStats"]

# Log-spaced bucket grid: 8 buckets per decade from 1us to 10^4 s.  Latency
# percentiles from a fixed grid are exact to ~+/-15% (one bucket), which is
# what a p99 regression gate needs — not microsecond forensics.
_BUCKETS_PER_DECADE = 8
_FLOOR_S = 1e-6
_DECADES = 10
_N_BUCKETS = _BUCKETS_PER_DECADE * _DECADES


class LatencyHistogram:
    """Fixed-grid log-bucketed latency histogram (seconds), thread-safe."""

    # Fields guarded by the named lock.
    _GUARDED_BY = {
        "_counts": "_lock",
        "_n": "_lock",
        "_sum": "_lock",
        "_max": "_lock",
    }

    def __init__(self):
        self._counts = [0] * _N_BUCKETS
        self._n = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(seconds: float) -> int:
        if seconds <= _FLOOR_S:
            return 0
        idx = int(math.log10(seconds / _FLOOR_S) * _BUCKETS_PER_DECADE)
        return min(idx, _N_BUCKETS - 1)

    @staticmethod
    def _bucket_mid(idx: int) -> float:
        # Geometric midpoint of the bucket's [lo, hi) span.
        return _FLOOR_S * 10.0 ** ((idx + 0.5) / _BUCKETS_PER_DECADE)

    def record(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        with self._lock:
            self._counts[self._bucket(s)] += 1
            self._n += 1
            self._sum += s
            self._max = max(self._max, s)

    @property
    def count(self) -> int:
        return self._n

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._n if self._n else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> seconds (geometric bucket midpoint; the true max
        is reported exactly for the topmost sample)."""
        with self._lock:
            if not self._n:
                return 0.0
            target = max(1, math.ceil(self._n * min(max(p, 0.0), 100.0) / 100.0))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    if seen == self._n and target == self._n:
                        return self._max  # the last sample: exact
                    return min(self._bucket_mid(i), self._max)
            return self._max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean_s": self.mean(),
            "p50_s": self.percentile(50.0),
            "p99_s": self.percentile(99.0),
            "max_s": self._max,
        }


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """Point-in-time snapshot of a scheduler's serving state.

    Attributes:
      queue_depth: requests admitted but not yet dispatched.
      sessions: resident prepared sessions (the bounded matrix pool).
      submitted / completed / failed: request outcomes so far.
      rejected_full: submissions refused by queue backpressure.
      rejected_deadline: requests whose deadline expired before dispatch.
      cancelled: requests cancelled while queued.
      groups: coalesced ``eigsh_many`` dispatches executed.
      grouped_queries: queries those dispatches served (so
        ``batch_occupancy = grouped_queries / groups``).
      coalesce_rate: fraction of completed queries that shared their sweep
        with at least one other query (0.0 = everything solo).
      warm_starts / cold_builds: sessions restored from the persistent store
        (zero conversions) vs built from scratch.
      retries: dispatch attempts re-queued after a retryable solve failure
        (each retry is one increment — a request retried twice counts 2).
      rejected_breaker: submissions refused because the matrix's circuit
        breaker was open (``SessionUnhealthyError``).
      breaker_trips: times a per-matrix breaker transitioned to open.
      watchdog_trips: dispatch-thread deaths detected by the watchdog.
      dispatch_errors: exceptions that escaped a dispatch and were contained
        by the loop guard (each one failed its group typed, not the thread).
      latency: per-phase histogram summaries (``queue`` / ``solve`` /
        ``e2e``), each with count / mean_s / p50_s / p99_s / max_s.
    """

    queue_depth: int
    sessions: int
    submitted: int
    completed: int
    failed: int
    rejected_full: int
    rejected_deadline: int
    cancelled: int
    groups: int
    grouped_queries: int
    coalesce_rate: float
    warm_starts: int
    cold_builds: int
    retries: int
    rejected_breaker: int
    breaker_trips: int
    watchdog_trips: int
    dispatch_errors: int
    latency: Dict[str, Dict[str, float]]

    @property
    def batch_occupancy(self) -> float:
        return self.grouped_queries / self.groups if self.groups else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_occupancy"] = self.batch_occupancy
        return d

    def summary(self) -> str:
        e2e = self.latency.get("e2e", {})
        q = self.latency.get("queue", {})
        return (
            f"served {self.completed}/{self.submitted} queries in {self.groups} sweeps "
            f"(occupancy {self.batch_occupancy:.2f}, coalesce rate {self.coalesce_rate:.2f})\n"
            f"  rejected: {self.rejected_full} full, {self.rejected_deadline} deadline; "
            f"cancelled {self.cancelled}; failed {self.failed}\n"
            f"  sessions: {self.sessions} resident "
            f"({self.warm_starts} warm-started, {self.cold_builds} cold-built)\n"
            f"  recovery: {self.retries} retries, {self.rejected_breaker} breaker-rejected "
            f"({self.breaker_trips} trips), {self.dispatch_errors} dispatch errors, "
            f"{self.watchdog_trips} watchdog trips\n"
            f"  latency e2e p50 {e2e.get('p50_s', 0.0) * 1e3:.2f}ms "
            f"p99 {e2e.get('p99_s', 0.0) * 1e3:.2f}ms; "
            f"queue p50 {q.get('p50_s', 0.0) * 1e3:.2f}ms p99 {q.get('p99_s', 0.0) * 1e3:.2f}ms"
        )


class ServingMetrics:
    """Mutable, thread-safe metric accumulators behind a scheduler."""

    # Fields guarded by the named lock (the ``inc`` counters go through
    # setattr under the same lock).
    _GUARDED_BY = {
        "groups": "_lock",
        "grouped_queries": "_lock",
        "coalesced_queries": "_lock",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected_full = 0
        self.rejected_deadline = 0
        self.cancelled = 0
        self.groups = 0
        self.grouped_queries = 0
        self.coalesced_queries = 0  # completed queries that shared a sweep
        self.warm_starts = 0
        self.cold_builds = 0
        self.retries = 0
        self.rejected_breaker = 0
        self.breaker_trips = 0
        self.watchdog_trips = 0
        self.dispatch_errors = 0
        self.queue_wait = LatencyHistogram()
        self.solve = LatencyHistogram()
        self.e2e = LatencyHistogram()

    def inc(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def record_group(self, size: int) -> None:
        with self._lock:
            self.groups += 1
            self.grouped_queries += size
            if size > 1:
                self.coalesced_queries += size

    def record_latency(self, queue_s: float, solve_s: float) -> None:
        self.queue_wait.record(queue_s)
        self.solve.record(solve_s)
        self.e2e.record(queue_s + solve_s)

    def snapshot(self, queue_depth: int = 0, sessions: int = 0) -> ServerStats:
        with self._lock:
            completed = self.completed
            coalesce_rate = self.coalesced_queries / completed if completed else 0.0
            return ServerStats(
                queue_depth=int(queue_depth),
                sessions=int(sessions),
                submitted=self.submitted,
                completed=completed,
                failed=self.failed,
                rejected_full=self.rejected_full,
                rejected_deadline=self.rejected_deadline,
                cancelled=self.cancelled,
                groups=self.groups,
                grouped_queries=self.grouped_queries,
                coalesce_rate=coalesce_rate,
                warm_starts=self.warm_starts,
                cold_builds=self.cold_builds,
                retries=self.retries,
                rejected_breaker=self.rejected_breaker,
                breaker_trips=self.breaker_trips,
                watchdog_trips=self.watchdog_trips,
                dispatch_errors=self.dispatch_errors,
                latency={
                    "queue": self.queue_wait.snapshot(),
                    "solve": self.solve.snapshot(),
                    "e2e": self.e2e.snapshot(),
                },
            )
