"""Counters, gauges, and latency histograms behind one registry.

The serving stack's instruments are deliberately boring: monotonically
increasing **counters** (frames in/out, launches, retry attempts per rung,
padded lanes, plan-cache hits, entropy words), point-in-time **gauges**
(pending-queue depth, active slots, in-flight launches), and
:class:`~repro_torch.obs.histogram.LatencyHistogram` **histograms** keyed by name.
A registry is just a namespace for them -- drivers, the serve engine, the
straggler watchdog, and benchmark harnesses all write into whichever registry
they are handed, so one process-wide registry sees the whole picture and a
per-driver registry isolates one tenant.

Everything is optional-by-construction: instrumented code guards each touch
with ``if metrics is not None``, so the unobserved path never allocates.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

from repro_torch.obs.histogram import LatencyHistogram


class MetricsRegistry:
    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, LatencyHistogram] = {}

    # -------------------------------------------------------------- counters
    def inc(self, name: str, n: int = 1) -> int:
        """Add ``n`` to counter ``name`` (created at 0); returns new value."""
        v = self.counters.get(name, 0) + n
        self.counters[name] = v
        return v

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    # ---------------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # ------------------------------------------------------------ histograms
    def hist(self, name: str, **kwargs) -> LatencyHistogram:
        """Get-or-create the named histogram (kwargs apply on first use)."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LatencyHistogram(**kwargs)
        return h

    def observe(self, name: str, ms: float, **kwargs) -> None:
        """Record one latency into the named histogram."""
        self.hist(name, **kwargs).observe(ms)

    # ------------------------------------------------------------- reporting
    def as_dict(self) -> dict:
        """Plain-data snapshot: counters, gauges, histogram summaries."""
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": {
                k: self.histograms[k].summary() for k in sorted(self.histograms)
            },
        }

    def write_hist_csv(self, path: str, extra: Optional[dict] = None) -> str:
        """Dump every histogram's non-empty bins as one CSV; returns ``path``.

        Columns: ``hist,bin_lo_ms,bin_hi_ms,count`` (plus any ``extra``
        key=value columns repeated on every row) -- the ``latency_hist.csv``
        artifact format the CI bench-smoke uploads.
        """
        extra = extra or {}
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["hist", "bin_lo_ms", "bin_hi_ms", "count", *extra])
            for name in sorted(self.histograms):
                for lo, hi, c in self.histograms[name].rows():
                    w.writerow([name, f"{lo:.6g}", f"{hi:.6g}", c, *extra.values()])
        return path
