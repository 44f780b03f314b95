"""bayes_decide_roofline: the kernel's share of its roofline, in %: the mean least
time of a call's work (the frozen count under portbench/counts, against the
card's peaks) over the mean device time of a bayes_decide launch in the trace."""

import statistics

KERNEL = "bayes_decide_kernel"


def read(ctx):
    times = [t for name, ts in ctx["trace"]["kernels"].items() if KERNEL in name for t in ts]
    if not times or not ctx["least_s"]:
        return None
    return 100.0 * statistics.fmean(ctx["least_s"]) / statistics.fmean(times)
