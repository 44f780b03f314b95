"""The harness on the CPU at small sizes: every cell runs and is correct with the
program as it is, and the control and each fault the cells can have come out
not correct."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "src"))

from portbench import harness  # noqa: E402
from portbench import run as bench_run  # noqa: E402
from portbench.tests.small import SMALL  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


def _run(cell_name, trace=False, fault=None, seconds=0.2):
    cell = harness.find_cell(BENCH, cell_name)
    return bench_run.run_cell(BENCH, cell, 2**31 + 77, seconds, trace, "cpu", time.perf_counter(),
                              overrides=SMALL[cell["config"]], fault=fault)


def _alter(entry, kind):
    """Break the program under ``entry``: one answer altered where it is
    produced, or half of the batch left out."""
    def broken(outs):
        outs = tuple(o.clone() for o in outs)
        first = outs[0]
        if kind == "alter":
            flat = first.reshape(-1)
            flat[0] = flat[0] + (1 if first.dtype != torch.float32 else 0.01)
        else:
            rows = first.shape[0] // 2
            for o in outs:
                o[rows:] = 0
        return outs

    if hasattr(entry, "nets"):
        for net in list(entry.nets):
            object.__setattr__(net, "decide", lambda key, ev, _f=net.decide: broken(_f(key, ev)))
        return
    call = entry._call
    entry._call = lambda key, p: broken(tuple(call(key, p)))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = harness.cell_metrics(BENCH, harness.find_cell(BENCH, cell))
    assert list(res["metrics"]) == [m["name"] for m in e2e]
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["alter", "half"])
def test_fault_is_not_correct(cell, kind):
    res = _run(cell, fault=lambda e: _alter(e, kind))
    assert not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg_name = harness.find_cell(BENCH, cell)
    config = harness.load_json(harness.ROOT / "configs" / f"{cfg_name['config']}.json")
    mix = harness.load_json(harness.ROOT / "workloads" / f"{cfg_name['traffic']}.json")
    small_cfg, small_mix = SMALL[cfg_name["config"]]
    config.update(small_cfg)
    mix.update(small_mix)
    if cfg_name["config"] == "paper-bayes-fusion":
        config.update(height=16, width=32)
    entry = harness.load_entry(mix["entry"]).Entry(config, mix, 5, "cpu", harness.Spans(False))
    records = [entry.plan(i) for i in range(mix["check"]["calls"])]
    checks = harness.check(entry, records, np.random.default_rng(1), control=True)
    assert not harness.is_correct(checks)


def test_traced_run_reads_its_metrics():
    res = _run("fusion-1080p.night", trace=True)
    assert res["correct"] and "breakdown" in res
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "ops_host_ms.fusion" in res["metrics"]


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch.cuda.is_available() is False")
    out = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                          "fusion-1080p.analytic", "--seed", "3", "--seconds", "2"],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
