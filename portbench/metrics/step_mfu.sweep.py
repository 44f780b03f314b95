"""The whole call's share of the card's peak, in %: the least time of all the
window's work (the frozen count under portbench/counts, whatever kernels
implement it) over the window's length."""


def read(ctx):
    if not ctx["least_s"]:
        return None
    return 100.0 * sum(ctx["least_s"]) / ctx["window_s"]
