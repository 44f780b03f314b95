"""ops_host_ms.fusion: host ms from entry to return of each call of the fusion
operator's public entry (``repro_torch.kernels.bayes_decide`` or
``fusion_map``: validation, launch sizing, the launch), the mean over the
traced window's calls, from the benchmark's ``entry`` spans."""

import statistics


def read(ctx):
    spans = ctx["spans"].get("entry")
    return statistics.fmean(spans) * 1e3 if spans else None
