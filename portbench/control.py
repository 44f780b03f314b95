"""The control of a cell's correctness check, at the cell's own size, on the card.

    python3 portbench/control.py --workload <name> --seeds 21,22,23

The control is the plain reference in the program's place, computed in the
precision below the one the configuration states: the class maps rounded to
bfloat16 before the DAC (the stochastic fusion cells), eq 5 in bfloat16 (the
analytic one), a 7-bit DAC for the sweep's 8-bit thresholds.  For each seed it
makes the cell's inputs, answers as many calls as a run checks (its rows or
frames sampled as a run samples them) and prints the numbers a run compares,
which a sound control fails.  The benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    harness.setup_paths()
    import numpy as np
    import torch

    from portbench import traffic as gen

    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(harness.ROOT / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.ROOT / "workloads" / f"{cell['traffic']}.json")
    readings = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = harness.load_entry(mix["entry"]).Entry(config, mix, seed, "cuda",
                                                       harness.Spans(False))
        records = [entry.plan(i) for i in range(mix["check"]["calls"])]
        checks = harness.check(entry, records, np.random.default_rng(gen.stream_seed(seed, 3)),
                               control=True)
        readings[seed] = checks
        print(f"{args.workload} seed {seed} control: {json.dumps(checks)}", flush=True)
        del entry
        torch.cuda.empty_cache()
    lows = {name: min(r[name]["value"] for r in readings.values())
            for name in next(iter(readings.values()))}
    print(json.dumps({"workload": args.workload, "control_min": lows, "readings": readings}))


if __name__ == "__main__":
    main()
