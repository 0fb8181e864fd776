"""Reading a ``torch.profiler`` trace of the window: the card's busy time,
device time by kernel, and the card's idle gaps by what the host was
doing meanwhile.

The union of device intervals is ``bench_torch/profile_eigsh.py``'s
``busy_us``, copied.  Times are the profiler's microseconds.
"""

from __future__ import annotations

import bisect
from typing import List, NamedTuple, Tuple

import torch

# Device-side records of the profiler itself, not of the program.
_PROFILER_RECORDS = ("Activity Buffer Request",)
# How far back to look for a host event that covers an idle gap.
_HOST_LOOKBACK = 256


class Trace(NamedTuple):
    window_us: float
    busy_us: float
    device: List[Tuple[str, float, float]]  # (name, start, end), by start
    host: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]  # the host's annotated spans, by start

    def device_us(self, needles) -> float:
        """Device microseconds of the activities whose name holds a needle."""
        return sum(e - s for name, s, e in self.device if any(nd in name for nd in needles))


def read(prof, window_us: float) -> Trace:
    dev, host, spans = [], [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        note = getattr(e, "is_user_annotation", False)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # A host span's mirror on the device timeline is no device work.
            if e.name not in _PROFILER_RECORDS and not note:
                dev.append(rec)
        else:
            (spans if note else host).append(rec)
    for xs in (dev, host, spans):
        xs.sort(key=lambda r: r[1])
    return Trace(window_us, busy_us(dev), dev, host, spans)


def busy_us(spans) -> float:
    """Device-busy microseconds: the union of the intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_ops(trace: Trace, top: int = 10) -> list:
    """The device activities that took most time: ``[[name, seconds], ...]``."""
    by = {}
    for name, s, e in trace.device:
        by[name] = by.get(name, 0.0) + (e - s)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], us / 1e6] for name, us in ranked]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The card's idle time between device activities, summed by the
    innermost host operation that covers each gap's middle, or else the
    annotated span (``eigbench.solve``) it falls in:
    ``[[host activity, seconds], ...]``, longest first."""
    starts = [s for _, s, _ in trace.host]
    span_starts = [s for _, s, _ in trace.spans]
    by = {}
    cur_e = None
    for _, s, e in trace.device:
        if cur_e is not None and s > cur_e:
            t = (cur_e + s) / 2
            label = _covering(trace.host, starts, t, _HOST_LOOKBACK)
            if label is None:  # Python or NumPy work inside a span, or between spans
                span = _covering(trace.spans, span_starts, t, 8)
                label = f"{span} (no torch op)" if span else "no profiled host event"
            by[label] = by.get(label, 0.0) + (s - cur_e)
        cur_e = e if cur_e is None else max(cur_e, e)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [["host: " + name[:190], us / 1e6] for name, us in ranked]


def _covering(events, starts, t: float, lookback: int):
    """The name of the latest-starting event that covers ``t``, looking
    back at most ``lookback`` events; None if none does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - lookback), -1):
        name, s, e = events[j]
        if e >= t:
            return name
    return None
