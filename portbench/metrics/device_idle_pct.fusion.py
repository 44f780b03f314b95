"""The device's idle share of the traced window, in %: the time in which no
kernel, copy or fill ran on the card, from torch.profiler's trace."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
