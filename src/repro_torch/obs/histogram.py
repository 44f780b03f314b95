"""Streaming latency histograms with exact percentile extraction.

The serving path's headline number is a *tail* latency -- the paper's claim is
"every decision inside 0.4 ms", not "the average decision" -- so the histogram
keeps two representations at once:

* **log-spaced bins** (``bins_per_decade`` per decade between ``lo_ms`` and
  ``hi_ms``, plus explicit under/overflow): constant memory, streamable,
  exportable as the ``latency_hist.csv`` artifact, and the right shape for
  latencies whose interesting structure spans orders of magnitude (a 5 us
  fused launch and a 50 ms recompile belong on the same axis).
* **retained raw samples** (up to ``max_samples``): percentiles quoted against
  a budget must be *exact*, not bin-midpoint approximations -- a 0.4 ms gate
  read off a bin whose edges are 0.32/0.56 ms would be theatre.  While the
  sample buffer holds every observation (the common case: benchmark runs are
  a few thousand samples), :meth:`percentile` reproduces
  ``numpy.percentile(..., method='linear')`` exactly; past the cap it falls
  back to bin interpolation and says so via :attr:`exact`.

``budget_ms`` is an annotation, not a filter: it rides into ``summary()`` /
CSV so every exported histogram carries the paper's 0.4 ms bar next to the
measured tail (:data:`PAPER_BUDGET_MS`).

Zero dependencies (stdlib only): the histogram must be importable from
benchmark harnesses, CI smoke steps, and the driver alike.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

try:  # optional fast path for observe_many; the histogram never requires it
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is always present in this repo
    _np = None

# The paper's timeliness claim: a decision every 0.4 ms (>= 2,500 fps).
PAPER_BUDGET_MS = 0.4

# (lo_ms, hi_ms, bins_per_decade) -> shared edges tuple (immutable, so safe)
_EDGE_CACHE: Dict[Tuple[float, float, int], Tuple[float, ...]] = {}


def percentile(samples: Sequence[float], q: float) -> float:
    """``numpy.percentile(samples, q, method='linear')`` on plain floats.

    Reimplemented (sorted copy + linear interpolation between closest ranks,
    numpy's exact formula) so the obs layer stays import-free; the test suite
    pins it against numpy on random samples.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(samples)
    if not xs:
        raise ValueError("percentile of no samples")
    rank = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(xs[int(rank)])
    return float(xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))


class LatencyHistogram:
    """Log-binned streaming histogram of millisecond latencies.

    ``observe(ms)`` is O(log n_bins); bins never reallocate.  Percentiles are
    exact (numpy-identical) while every sample fits in the retention buffer,
    bin-interpolated (with :attr:`exact` = False) after.
    """

    def __init__(
        self,
        lo_ms: float = 1e-3,
        hi_ms: float = 1e4,
        bins_per_decade: int = 8,
        budget_ms: Optional[float] = None,
        max_samples: int = 1 << 16,
    ):
        if not (0 < lo_ms < hi_ms):
            raise ValueError(f"need 0 < lo_ms < hi_ms, got {lo_ms}, {hi_ms}")
        if bins_per_decade < 1:
            raise ValueError("bins_per_decade must be >= 1")
        # edges[0] == lo_ms; the last edge lands on or just past hi_ms.  The
        # ladder is cached across instances: registries construct histograms
        # lazily inside latency-critical paths, and ~60 pow() calls per
        # construction is a measurable slice of the driver's overhead budget.
        ladder = (lo_ms, hi_ms, bins_per_decade)
        edges = _EDGE_CACHE.get(ladder)
        if edges is None:
            n = math.ceil(round(math.log10(hi_ms / lo_ms) * bins_per_decade, 9))
            edges = _EDGE_CACHE[ladder] = tuple(
                lo_ms * 10.0 ** (i / bins_per_decade) for i in range(n + 1)
            )
        self.edges: Tuple[float, ...] = edges
        # counts[0] = underflow (< lo_ms), counts[-1] = overflow (>= last edge)
        self.counts: List[int] = [0] * (len(edges) + 1)
        self.budget_ms = budget_ms
        self.max_samples = int(max_samples)
        self._edges_arr = None   # numpy copy of edges, built on first bulk use
        self._samples: List[float] = []
        self.n = 0
        self.total_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = -math.inf
        self.under_budget = 0

    # ------------------------------------------------------------- recording
    def observe(self, ms: float) -> None:
        ms = float(ms)
        self.counts[bisect_right(self.edges, ms)] += 1
        self.n += 1
        self.total_ms += ms
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)
        if self.budget_ms is not None and ms <= self.budget_ms:
            self.under_budget += 1
        if len(self._samples) < self.max_samples:
            self._samples.append(ms)

    def observe_many(self, ms_values: Sequence[float]) -> None:
        """Bulk :meth:`observe` -- vectorised when numpy is importable.

        The driver harvests whole launches (up to ``max_batch`` frame
        latencies at once); per-frame Python-loop observes would cost a
        measurable fraction of a sub-millisecond launch, which is exactly
        the overhead the obs layer is gated not to add.
        """
        if _np is None:
            for ms in ms_values:
                self.observe(ms)
            return
        vals = _np.asarray(ms_values, float).ravel()
        if vals.size == 0:
            return
        if self._edges_arr is None:
            self._edges_arr = _np.asarray(self.edges)
        idx = _np.searchsorted(self._edges_arr, vals, side="right")
        binc = _np.bincount(idx, minlength=len(self.counts))
        for i in _np.nonzero(binc)[0]:
            self.counts[int(i)] += int(binc[i])
        self.n += int(vals.size)
        self.total_ms += float(vals.sum())
        self.min_ms = min(self.min_ms, float(vals.min()))
        self.max_ms = max(self.max_ms, float(vals.max()))
        if self.budget_ms is not None:
            self.under_budget += int((vals <= self.budget_ms).sum())
        room = self.max_samples - len(self._samples)
        if room > 0:
            self._samples.extend(vals[:room].tolist())

    # ------------------------------------------------------------ extraction
    @property
    def exact(self) -> bool:
        """True while the retention buffer holds every observation."""
        return self.n == len(self._samples)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.n if self.n else math.nan

    def percentile(self, q: float) -> float:
        """Latency at quantile ``q`` (exact while :attr:`exact` holds)."""
        if self.n == 0:
            raise ValueError("percentile of an empty histogram")
        if self.exact:
            return percentile(self._samples, q)
        # bin fallback: linear interpolation inside the bin holding rank q.
        # Under/overflow bins clamp to the observed extremes.
        rank = (self.n - 1) * (q / 100.0)
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c > rank:
                lo = self.min_ms if i == 0 else self.edges[i - 1]
                hi = self.max_ms if i == len(self.counts) - 1 else self.edges[i]
                lo, hi = max(lo, self.min_ms), min(hi, self.max_ms)
                return lo + (hi - lo) * ((rank - seen) / c)
            seen += c
        return self.max_ms

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p90(self) -> float:
        return self.percentile(90.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def budget_fraction(self) -> float:
        """Fraction of observations at or under ``budget_ms`` (nan if unset)."""
        if self.budget_ms is None or self.n == 0:
            return math.nan
        return self.under_budget / self.n

    def summary(self) -> Dict[str, float]:
        if self.n == 0:
            return {"n": 0}
        out = {
            "n": self.n,
            "mean_ms": self.mean_ms,
            "min_ms": self.min_ms,
            "max_ms": self.max_ms,
            "p50_ms": self.p50,
            "p90_ms": self.p90,
            "p99_ms": self.p99,
            "exact": self.exact,
        }
        if self.budget_ms is not None:
            out["budget_ms"] = self.budget_ms
            out["budget_fraction"] = self.budget_fraction()
        return out

    def rows(self) -> List[Tuple[float, float, int]]:
        """Non-empty ``(bin_lo_ms, bin_hi_ms, count)`` rows, CSV-ready.

        Underflow reports ``(0, lo_ms)``, overflow ``(last_edge, inf)``.
        """
        out = []
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = 0.0 if i == 0 else self.edges[i - 1]
            hi = math.inf if i == len(self.counts) - 1 else self.edges[i]
            out.append((lo, hi, c))
        return out
