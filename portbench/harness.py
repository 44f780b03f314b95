"""The benchmark's general part: one run of one cell of ``BENCHMARK.json``.

A run finds its cell in ``BENCHMARK.json``, the configuration in
``portbench/configs/<config>.json`` and the traffic mix in
``portbench/workloads/<traffic>.json``.  The mix names its entry, a module
``portbench/entries/<entry>.py`` that drives one entry point of the program;
per-layer metrics are read by ``portbench/metrics/<metric>.py``.  So a new
configuration, mix or metric is a new file, and this module stays as it is.

A run: set-up (the program, the inputs from ``--seed``, every shape warmed),
then a closed loop that hands over call after call, ``ahead`` in flight, for
``--seconds``; then the calls still in flight finish, and the window ends at
the last result.  With ``--trace 1`` the window runs under ``torch.profiler``
with the benchmark's own spans around each call into the program, and the
per-layer metrics are read from them.  Then the check: the answers of calls
sampled from the seed are held against the plain reference.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent          # portbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")           # top-level module names, compared whole


class Spans:
    """The benchmark's spans around calls into the program.

    Off (``trace=False``) a span costs one shared null context.  On, each span
    keeps its host duration by ``time.perf_counter`` and marks the profiler's
    timeline with ``record_function("pb.<name>")``, which names the device's
    idle gaps by what the host was doing.
    """

    def __init__(self, trace: bool):
        self.trace = trace
        self.durations = collections.defaultdict(list)
        self._null = contextlib.nullcontext()

    def __call__(self, name: str):
        return self._span(name) if self.trace else self._null

    @contextlib.contextmanager
    def _span(self, name):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function("pb." + name):
            yield
        self.durations[name].append(time.perf_counter() - t)


def load_json(path: pathlib.Path):
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict) -> tuple:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    return e2e, per_layer


def load_entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def load_reader(metric: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Reservoir:
    """A uniform sample, drawn from the seed, of ``k`` calls of the window."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.kept = k, rng, 0, {}

    def offer(self, take):
        """Keep the next call (``take()`` makes its record) with the right chance."""
        if self.seen < self.k:
            self.kept[self.seen] = take()
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.k:
                self.kept[slot] = take()
        self.seen += 1

    def records(self) -> list:
        return [self.kept[s] for s in sorted(self.kept)]


def closed_loop(entry, seconds: float, spans: Spans, reservoir: Reservoir) -> dict:
    """Hand calls over, ``entry.ahead`` in flight, for ``seconds``; then drain.

    Returns the window's start and end (host clock), the calls, and each
    call's time from hand-over to its results being ready.
    """
    inflight = collections.deque()
    latencies = []
    i = 0
    t_done = t0 = time.perf_counter()
    t_end = t0 + seconds

    def complete():
        nonlocal t_done
        j, ts, handle = inflight.popleft()
        with spans("wait"):
            entry.wait(handle)
        t_done = time.perf_counter()
        latencies.append(t_done - ts)
        reservoir.offer(lambda: entry.retain(j, handle))

    while time.perf_counter() < t_end:
        if len(inflight) >= entry.ahead:
            complete()
        ts = time.perf_counter()
        inflight.append((i, ts, entry.submit(i)))
        i += 1
    while inflight:
        complete()
    return {"t0": t0, "t1": t_done, "calls": i, "latencies": latencies}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check(entry, records, rng, control: bool = False) -> dict:
    """{name: {"value", "limit"}} of the numbers compared with the reference."""
    readings = entry.check(records, rng, control=control)
    return {name: {"value": value, "limit": entry.limits[name]} for name, value in readings.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def setup_paths():
    """Keep every build and kernel cache of the program inside the checkout,
    at fixed paths, and make the program importable."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch-extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda-cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch-kernels")
    os.environ["USE_FLAX"] = "0"
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
