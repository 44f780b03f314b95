"""decide_host_ms: host ms of each ``CompiledNetwork.decide`` call (the
evidence upload, the plan's launch, the posterior assembly enqueued), the
mean over the traced window's calls, from the benchmark's ``decide`` spans."""

import statistics


def read(ctx):
    spans = ctx["spans"].get("decide")
    return statistics.fmean(spans) * 1e3 if spans else None
