"""Lightweight, zero-dep telemetry for the serving path (DESIGN.md §13).

    trace.py      Tracer / Span -- nested sync spans + async (dispatch-to-
                  harvest) spans, counters beside them (host totals, and
                  device tensors a kernel adds to, read once after the
                  work), Chrome/Perfetto JSON export, optional
                  torch.profiler record_function passthrough
    metrics.py    MetricsRegistry -- counters / gauges / named histograms
    histogram.py  LatencyHistogram -- log-spaced streaming bins with exact
                  p50/p90/p99 while samples are retained, and the paper's
                  0.4 ms budget annotation (PAPER_BUDGET_MS)

Everything is off by default: instrumented layers take ``trace=None`` /
``metrics=None`` and the untouched path stays bit-identical (regression-
tested, not assumed).  Besides the driver, router and engine, the decision
path (``CompiledNetwork.decide`` / ``run``: ``net.upload``, ``net.sweep``,
``net.assemble``) and the fusion operators' entries (``op.prepare``,
``op.launch``; ``bayes_decide`` also counts the streams its kernel queues
for hashing) record spans when given a tracer.

The crossbar-health loop (DESIGN.md §15) publishes through the same
registry: each :class:`~repro_torch.bayesnet.DriftMonitor` exports per-statistic
CUSUM gauges (``<name>_drift_score_*``, ``<name>_drift_state``) plus alarm /
reset counters, and the router adds ``router_recalibrations`` and the
driver ``net_swaps`` / ``escalation_clamped`` counters, so a dashboard can
watch a tenant walk HEALTHY -> DRIFTING -> RECALIBRATING and back.
"""

from repro_torch.obs.histogram import (  # noqa: F401
    PAPER_BUDGET_MS,
    LatencyHistogram,
    percentile,
)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Span, Tracer  # noqa: F401
