"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics come from ``BENCHMARK.json`` and the files under
``portbench/`` (see ``portbench/harness.py``).  Without a CUDA card, or with
fewer cards than the cell asks for, the run prints no result and exits 2.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the reference,
beside its limit, which the run also prints as its last lines on standard
error.
"""

import time

T_START = time.perf_counter()   # the process's start, as near as a script can take it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

WARM_CALLS = 2        # extra batches beyond those in flight and those the check keeps


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, overrides=None, fault=None) -> dict:
    """One run of ``cell``: set-up, the window, the check.  Returns the result
    line as a dict.  ``overrides`` updates the configuration and traffic
    (the tests' small sizes); ``fault(entry)`` breaks the program under test."""
    import numpy as np
    import torch

    from portbench import traffic as gen

    config = harness.load_json(harness.ROOT / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.ROOT / "workloads" / f"{cell['traffic']}.json")
    for part, extra in zip((config, mix), overrides or ({}, {})):
        part.update(extra)
    e2e, per_layer = harness.cell_metrics(bench, cell)
    cuda = torch.device(device).type == "cuda"
    spans = harness.Spans(trace)
    entry = harness.load_entry(mix["entry"]).Entry(config, mix, seed, device, spans)
    if fault is not None:
        fault(entry)
    kept = mix["check"]["calls"]
    entry.warm(entry.ahead + kept + WARM_CALLS)
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives on: the collector no longer walks it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    reservoir = harness.Reservoir(kept, np.random.default_rng(gen.stream_seed(seed, 2)))
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function("pb.window"):
                loop = harness.closed_loop(entry, seconds, spans, reservoir)
        from portbench import trace as tr

        summary = tr.summarize(prof.events())
    else:
        loop = harness.closed_loop(entry, seconds, spans, reservoir)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_s = loop["t1"] - loop["t0"]
    metrics = {}
    if not trace:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else loop["calls"] * entry.units_per_call / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = {"spans": dict(spans.durations), "latencies": loop["latencies"],
               "calls": loop["calls"], "window_s": window_s, "trace": summary,
               "least_s": None}
        if cuda:
            from portbench.counts.yardstick import card_peaks

            peaks = card_peaks()
            print(f"peaks: {peaks.name}, power limit {peaks.power_limit}, {peaks.sms} SMs at "
                  f"{peaks.max_sm_mhz} MHz", file=sys.stderr)
            ctx["least_s"] = [entry.least_s(i, peaks) for i in range(loop["calls"])]
        for m in per_layer:
            value = harness.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    checks = harness.check(entry, reservoir.records(),
                           np.random.default_rng(gen.stream_seed(seed, 3)))
    print(f"set-up {setup_s:.3f} s, window {window_s:.3f} s ({loop['calls']} calls), "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result = {
        "correct": harness.is_correct(checks),
        "attempted": loop["calls"],
        "failed": loop["calls"] - len(loop["latencies"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def new_builds(since: float) -> int:
    """Kernel libraries written into the checkout's build/ since ``since`` (epoch s)."""
    build = harness.CHECKOUT / "build"
    return sum(1 for p in build.glob("*.so") if p.stat().st_mtime >= since) if build.exists() else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = time.time()
    harness.setup_paths()
    import torch

    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 1
    print(f"kernel libraries built in this run: {new_builds(started)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
