"""Reading a traced window: device time by operation, busy and idle time, and
the idle gaps named by the benchmark span the host was in.

The window is the profiler's ``pb.window`` range; device activities are the
trace's CUDA events (kernels, copies, fills), clipped to it, and the busy time
is their union (as ``chip_smoke.py::_busy_us`` takes it).  A gap is time in
the window in which no device activity ran; each is split over the leaf
``pb.*`` spans that overlap it, and what no span covers is ``host (other)``.
"""

from __future__ import annotations

import collections

TOP = 10


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def summarize(events) -> dict:
    """Per-window numbers from ``torch.profiler``'s events (times in us).

    Returns ``window_s``, ``busy_s``, ``kernels`` (name -> list of device
    seconds, each activity clipped to the window), ``device_ops`` and
    ``idle_gaps`` (the breakdown lists, at most 10 entries each).
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, spans = [], []
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if not e.name.startswith("pb."):     # not the spans' own ranges on the device's timeline
                device.append((e.name, a, b))
        elif e.name == "pb.window":
            window = (a, b)
        elif e.name.startswith("pb."):
            spans.append((e.name[3:], a, b))
    if window is None:
        raise RuntimeError("the trace holds no pb.window range")
    w0, w1 = window
    kernels = collections.defaultdict(list)
    inside = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[name].append((b - a) / 1e6)
            inside.append((a, b))
    busy = _union(inside)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans.sort(key=lambda s: s[1])      # leaf spans of one thread: disjoint, so ends sort too
    idle = collections.Counter()
    first = 0
    for g0, g1 in gaps:
        while first < len(spans) and spans[first][2] <= g0:
            first += 1
        covered = 0.0
        for x in range(first, len(spans)):
            name, a, b = spans[x]
            if a >= g1:
                break
            ov = _overlap(g0, g1, a, b)
            idle[name] += ov
            covered += ov
        if g1 - g0 > covered:
            idle["host (other)"] += g1 - g0 - covered
    ops = sorted(((n, sum(v)) for n, v in kernels.items()), key=lambda x: -x[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": dict(kernels),
        "device_ops": [[n[:200], s] for n, s in ops],
        "idle_gaps": [[n, us / 1e6] for n, us in idle.most_common(TOP)],
    }
