"""A traced window of one cell with the program's own tracer handed in.

    python3 portbench/program_trace.py --workload <name> --seed <n> --seconds <s>
        [--program-trace 0|1]

from the root of a checkout, on the card.  The cell is set up as
``portbench/run.py`` sets it up; with ``--program-trace 1`` (the default)
its entry point is given a ``repro_torch.obs.Tracer(annotate=True)``: each
network's ``trace`` in the sweep, ``trace=`` on each operator call in the
fusion cells.  The window then runs under ``torch.profiler`` with the
benchmark's own spans, as a ``--trace 1`` run does, and the check follows.
With ``--program-trace 0`` the program gets no tracer, so that a pair of
runs gives the cost of its tracing when on.

The last line of standard output is one JSON object: ``correct``, the
window's ``calls`` and rate, ``outside`` (the benchmark's own spans:
``decide_host_ms``, ``ops_host_ms.fusion``), ``program`` (the mean host ms of
each program span per call, the idle split, the counters over the window),
``readings`` (the per-layer numbers of :func:`readings`), and ``device``
(busy and idle of the window, with the device timeline's user annotations
left out by kind, and as ``trace.summarize`` reads them, by name).

The program's spans come from the tracer's host records (``time.perf_counter``,
the clock the window is taken by), the idle split from their copies in the
profiler's timeline, on the clock of the kernels and copies.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench.trace import _union  # noqa: E402

PROGRAM = ("net.", "op.")        # prefixes of the program's span names
WARM_CALLS = 2                   # as run.py


def is_annotation(e) -> bool:
    """Whether a profiler event is a ``record_function`` range (on the host
    or its copy on the device's timeline), by the profiler's own flag."""
    return bool(getattr(e, "is_user_annotation", False))


def innermost(spans):
    """Disjoint (name, start, end) pieces of nested host spans, each piece
    named by the innermost span covering it.  ``spans`` are (name, start,
    end) ranges of one thread, so any two nest or are apart."""
    pieces, stack = [], []          # stack: [name, end, covered up to]

    def close_until(t):
        while stack and stack[-1][1] <= t:
            name, end, at = stack.pop()
            if end > at:
                pieces.append((name, at, end))
            if stack:
                stack[-1][2] = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        if stack and a > stack[-1][2]:
            pieces.append((stack[-1][0], stack[-1][2], a))
        stack.append([name, b, a])
    close_until(float("inf"))
    return sorted(pieces, key=lambda p: p[1])


def summarize_program(events, prefixes=PROGRAM) -> dict:
    """The traced window's device busy time and its idle time by program span.

    Device activities are the CUDA events that are not user annotations (so
    neither the benchmark's nor the program's ``record_function`` copies on
    the device's timeline count as work), clipped to ``pb.window``.  Each
    idle gap is split over the innermost program span (a host annotation
    whose name starts with one of ``prefixes``) covering it; what no program
    span covers is ``outside the program``.  Returns ``window_s``,
    ``busy_s``, ``device_ops`` (name -> device seconds), ``annotations``
    (user annotations on the device's timeline, left out) and
    ``program_idle`` (name -> idle seconds), times in seconds.
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window, device, spans, left_out = None, [], [], 0
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if is_annotation(e):
                left_out += 1
            else:
                device.append((e.name, a, b))
        elif e.name == "pb.window":
            window = (a, b)
        elif e.name.startswith(prefixes):
            spans.append((e.name, a, b))
    if window is None:
        raise RuntimeError("the trace holds no pb.window range")
    w0, w1 = window
    ops, inside = collections.Counter(), []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops[name] += (b - a) / 1e6
            inside.append((a, b))
    busy = _union(inside)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    pieces = innermost(spans)
    idle = collections.Counter()
    first = 0
    for g0, g1 in gaps:
        while first < len(pieces) and pieces[first][2] <= g0:
            first += 1
        covered = 0.0
        for name, a, b in pieces[first:]:
            if a >= g1:
                break
            ov = min(g1, b) - max(g0, a)
            if ov > 0:
                idle[name] += ov / 1e6
                covered += ov
        if g1 - g0 > covered:
            idle["outside the program"] += (g1 - g0 - covered) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": dict(ops), "annotations": left_out, "program_idle": dict(idle)}


def span_means(spans) -> dict:
    """Mean host ms of each span name over ``spans`` (done ones)."""
    by = collections.defaultdict(list)
    for s in spans:
        if s.done:
            by[s.name].append(s.dur_ms)
    return {n: statistics.fmean(v) for n, v in sorted(by.items())}


def readings(means: dict, counts: dict, program_idle: dict, window_s: float) -> dict:
    """The per-layer numbers the program's spans and counters give a window:

    * ``decide_upload_ms``, ``decide_sweep_ms``, ``decide_assemble_ms``: the
      mean ``net.upload``, ``net.sweep``, ``net.assemble`` per call;
    * ``idle_in_upload_pct.sweep``: the share of the window, in %, in which
      the card ran nothing while the host was in ``net.upload``;
    * ``ops_launch_ms.fusion``: the mean ``op.launch`` per call;
    * ``bayes_decide_queued_pct``: the streams ``bayes_decide`` queued for
      hashing over the window, in % of the (row, class) streams it was given.

    A number whose spans or counters the window lacks is left out.
    """
    out = {}
    for name, span in (("decide_upload_ms", "net.upload"), ("decide_sweep_ms", "net.sweep"),
                       ("decide_assemble_ms", "net.assemble"), ("ops_launch_ms.fusion",
                                                                "op.launch")):
        if span in means:
            out[name] = means[span]
    if "net.upload" in means and window_s > 0:
        out["idle_in_upload_pct.sweep"] = 100.0 * program_idle.get("net.upload", 0.0) / window_s
    if counts.get("bayes_decide.streams"):
        out["bayes_decide_queued_pct"] = (100.0 * counts.get("bayes_decide.queued", 0)
                                          / counts["bayes_decide.streams"])
    return out


def rule_queued_pct(entry, calls: int, block: int = 1 << 20):
    """The share of streams, in %, that the thresholds rule queues over calls
    ``0 .. calls - 1`` of a ``bayes_decide`` cell: a stream is queued when no
    modality rounds to level 0 and some modality rounds below 256."""
    import torch

    if getattr(entry, "operator", None) != "bayes_decide" or calls <= 0:
        return None
    per_slot = []
    for p in entry.ring:
        flat = p.reshape(p.shape[0], -1, p.shape[-1])
        n = 0
        for a in range(0, flat.shape[1], block):
            t = torch.clamp(torch.round(flat[:, a:a + block] * 256), 0, 256)
            n += int(((t > 0).all(0) & (t < 256).any(0)).sum())
        per_slot.append(n / (flat.shape[1] * flat.shape[2]))
    ring = len(per_slot)
    return 100.0 * sum(per_slot[i % ring] for i in range(calls)) / calls


def _idle_pct(summary):
    w = summary["window_s"]
    return 100.0 * (1.0 - summary["busy_s"] / w) if w > 0 else None


def hand_tracer(entry, tracer):
    """Give the entry's program ``tracer``: the sweep's networks keep it, the
    fusion operator is called with ``trace=tracer``."""
    if hasattr(entry, "nets"):
        entry.nets = [dataclasses.replace(net, trace=tracer) for net in entry.nets]
    else:
        entry.op = functools.partial(entry.op, trace=tracer)


def trace_cell(bench: dict, cell: dict, seed: int, seconds: float, device: str,
               program_trace: bool = True, overrides=None) -> dict:
    """One traced window of ``cell`` (see the module's docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import traffic as gen
    from portbench.trace import summarize
    from repro_torch.obs import Tracer

    config = harness.load_json(harness.ROOT / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.ROOT / "workloads" / f"{cell['traffic']}.json")
    for part, extra in zip((config, mix), overrides or ({}, {})):
        part.update(extra)
    cuda = torch.device(device).type == "cuda"
    spans = harness.Spans(True)
    entry = harness.load_entry(mix["entry"]).Entry(config, mix, seed, device, spans)
    tracer = Tracer(annotate=True)
    if program_trace:
        hand_tracer(entry, tracer)
    kept = mix["check"]["calls"]
    entry.warm(entry.ahead + kept + WARM_CALLS)
    if cuda:
        torch.cuda.synchronize()
    before = tracer.totals()
    first_span = len(tracer.spans)
    warm_spans = {name: len(d) for name, d in spans.durations.items()}
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    reservoir = harness.Reservoir(kept, np.random.default_rng(gen.stream_seed(seed, 2)))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function("pb.window"):
            loop = harness.closed_loop(entry, seconds, spans, reservoir)
    events = prof.events()
    by_name = summarize(events)
    by_kind = summarize_program(events)
    after = tracer.totals()
    counts = {n: v - before.get(n, 0) for n, v in after.items()}
    window_s = loop["t1"] - loop["t0"]
    means = span_means(tracer.spans[first_span:])
    # as the benchmark's readers take them (warm-up included), and the window's alone
    outside = {}
    for metric, name in (("decide_host_ms", "decide"), ("ops_host_ms.fusion", "entry")):
        if spans.durations.get(name):
            outside[metric] = statistics.fmean(spans.durations[name]) * 1e3
            window = spans.durations[name][warm_spans.get(name, 0):]
            outside[metric + ".window"] = statistics.fmean(window) * 1e3 if window else None
    checks = harness.check(entry, reservoir.records(),
                           np.random.default_rng(gen.stream_seed(seed, 3)))
    return {
        "workload": cell["name"], "seed": seed, "program_trace": program_trace,
        "correct": harness.is_correct(checks), "setup_s": setup_s,
        "calls": loop["calls"], "window_s": window_s,
        "units_per_s": loop["calls"] * entry.units_per_call / window_s,
        "outside": outside,
        "program": {"span_ms": means, "counters": counts,
                    "idle_s": dict(sorted(by_kind["program_idle"].items(),
                                          key=lambda kv: -kv[1]))},
        "readings": readings(means, counts, by_kind["program_idle"], by_kind["window_s"]),
        "rule_queued_pct": rule_queued_pct(entry, loop["calls"]),
        "device": {"busy_s": by_kind["busy_s"], "window_s": by_kind["window_s"],
                   "idle_pct": _idle_pct(by_kind), "annotations_left_out": by_kind["annotations"],
                   "idle_pct_by_name": _idle_pct(by_name),
                   "kind": torch.cuda.get_device_name() if cuda else "cpu"},
        "checks": checks,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    harness.setup_paths()
    import torch

    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    result = trace_cell(bench, cell, args.seed, args.seconds, "cuda", bool(args.program_trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
