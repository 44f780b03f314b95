"""``BENCHMARK.json`` against the contract, and what a run may load: no module of
JAX or of the JAX package, no file of the JAX package's benchmarks, and no
result without a card."""

import json
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "src"))

from portbench import harness  # noqa: E402
from portbench.tests.small import SMALL  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for cfg in BENCH["configs"]:
        assert (REPO / cfg["file"]).is_file() and cfg["file"].startswith("portbench/")
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (harness.ROOT / "workloads" / f"{cell['traffic']}.json").is_file()
        e2e_here, per_layer = harness.cell_metrics(BENCH, cell)
        assert "setup_s" in {m["name"] for m in e2e_here} and len(e2e_here) >= 2 and per_layer
    for m in BENCH["per_layer"]:
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_jax_and_no_reference_benchmarks(tmp_path):
    """A whole small run in a fresh process loads no module named jax, jaxlib,
    flax or repro (top-level names, compared whole) and opens nothing of the
    JAX package's benchmarks/ or BENCH_*.json."""
    script = f"""
import sys, time, json, os
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(REPO / 'src')!r})
from portbench import harness, run
bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
small = {SMALL!r}
for cell in bench["workloads"]:
    run.run_cell(bench, cell, 9, 0.1, False, "cpu", time.perf_counter(),
                 overrides=small[cell["config"]])
for m in bench["per_layer"]:
    harness.load_reader(m["name"])
mods = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}})
bad = [p for p in opened if "/benchmarks/" in p or os.path.basename(p).startswith("BENCH_")]
print(json.dumps({{"mods": mods, "bad": bad}}))
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == {"mods": [], "bad": []}


def test_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "reference").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro_torch|repro|jax)\b", text, re.M), path
    for path in (harness.ROOT / "counts").glob("*.py"):
        assert not re.search(r"^\s*(from|import)\s+(repro_torch|repro|jax)\b",
                             path.read_text(), re.M), path


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
