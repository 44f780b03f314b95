"""Run cells several times, one process a run, and summarise the spread.

    python3 portbench/sets.py --workload <name> [--workload ...] --seeds 11,12,13
        --seconds 10 [--trace 0] [--out build/sets]

Each run is ``portbench/run.py`` in a process of its own, one after the
other; its standard output and error go to ``<out>/<workload>.<seed>.<trace>``.
The summary prints, per cell and metric, every run's value, the median and
the spread (interquartile range over the median, by
``statistics.quantiles(n=4)``), the set-up of each run, ``correct`` and the
numbers compared; as JSON on the last line.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def one_run(workload, seed, seconds, trace, out: pathlib.Path) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                          capture_output=True, text=True, cwd=HERE.parent)
    wall = time.perf_counter() - t
    stem = out / f"{workload}.{seed}.{trace}"
    stem.with_suffix(stem.suffix + ".out").write_text(proc.stdout)
    stem.with_suffix(stem.suffix + ".err").write_text(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
            "stderr_tail": proc.stderr[-2000:] if result is None else proc.stderr[-600:]}


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="build/sets")
    args = ap.parse_args()
    out = HERE.parent / args.out
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    for wl in args.workload:
        runs = [one_run(wl, s, args.seconds, args.trace, out) for s in seeds]
        per = {}
        for r in runs:
            res = r["result"]
            print(f"{wl} seed {r['seed']} rc {r['rc']} wall {r['wall_s']:.1f} s: "
                  + (json.dumps(res) if res else r["stderr_tail"]), flush=True)
            if res:
                for name, m in res["metrics"].items():
                    per.setdefault(name, []).append(m["value"])
        summary[wl] = {
            "metrics": {n: {"values": v, "median": statistics.median(v), "spread": spread(v)}
                        for n, v in per.items()},
            "correct": [r["result"]["correct"] if r["result"] else None for r in runs],
            "checks": [r["result"]["checks"] if r["result"] else None for r in runs],
            "rc": [r["rc"] for r in runs],
        }
        for n, s in summary[wl]["metrics"].items():
            print(f"{wl} {n}: median {s['median']} spread {s['spread']}", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
