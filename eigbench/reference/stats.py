"""The benchmark's arithmetic on samples: percentiles and rates.

Plain Python, so that the yardstick does not depend on a library's
choice of quantile method.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks (NumPy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_item_ms(window_s: float, count: int) -> float:
    """Milliseconds per item over a window in which ``count`` items ended."""
    if count <= 0:
        raise ValueError("no item completed in the window")
    return window_s * 1e3 / count

