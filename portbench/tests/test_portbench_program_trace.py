"""The program-traced window (``portbench/program_trace.py``) on the CPU: the
idle split over the program's spans on synthetic profiler events, and a
traced run of the sweep and of the night cell reading the program's spans
and counters."""

import json
import pathlib
import sys
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "src"))

from portbench import harness  # noqa: E402
from portbench import program_trace as pt  # noqa: E402
from portbench.tests.small import SMALL  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, a, b, device=CPU, annotation=False):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_type=device, is_user_annotation=annotation)


def _events(with_device_annotations: bool):
    """A 100 us window: a decide call whose upload leaves the card idle from
    10 to 30 us, a sweep kernel 30-70 us, and the card idle again in the
    assembly (70-80 us) and after the call (80-100 us)."""
    ev = [_ev("pb.window", 0, 100, annotation=True),
          _ev("pb.decide", 5, 80, annotation=True),
          _ev("net.decide", 5, 80, annotation=True),
          _ev("net.upload", 10, 30, annotation=True),
          _ev("net.sweep", 30, 35, annotation=True),
          _ev("net.assemble", 70, 80, annotation=True),
          _ev("Memcpy HtoD", 0, 10, CUDA),
          _ev("net_sweep_kernel", 30, 70, CUDA)]
    if with_device_annotations:
        ev += [_ev("net.upload", 9, 31, CUDA, True), _ev("net.decide", 9, 90, CUDA, True),
               _ev("pb.decide", 9, 90, CUDA, True)]
    return ev


def test_idle_split_leaves_device_annotations_out_and_names_the_upload():
    plain, annotated = pt.summarize_program(_events(False)), pt.summarize_program(_events(True))
    for key in ("window_s", "busy_s", "device_ops", "program_idle"):
        assert annotated[key] == plain[key]
    assert (plain["annotations"], annotated["annotations"]) == (0, 3)
    assert plain["busy_s"] == pytest.approx(50e-6)
    idle = plain["program_idle"]
    assert idle["net.upload"] == pytest.approx(20e-6)
    assert idle["net.assemble"] == pytest.approx(10e-6)
    assert idle["outside the program"] == pytest.approx(20e-6)
    assert "net.sweep" not in idle and "net.decide" not in idle


def test_innermost_pieces_name_each_instant_by_its_deepest_span():
    spans = [("P", 0, 10), ("A", 1, 3), ("C", 1.5, 2), ("B", 5, 7)]
    assert pt.innermost(spans) == [("P", 0, 1), ("A", 1, 1.5), ("C", 1.5, 2), ("A", 2, 3),
                                   ("P", 3, 5), ("B", 5, 7), ("P", 7, 10)]


READS = {"sweep-262144.mixed7": {"decide_upload_ms", "decide_sweep_ms", "decide_assemble_ms",
                                 "idle_in_upload_pct.sweep"},
         "fusion-1080p.night": {"ops_launch_ms.fusion", "bayes_decide_queued_pct"}}


@pytest.mark.parametrize("cell", sorted(READS))
def test_program_traced_run_reads_its_spans_and_counters(cell):
    c = harness.find_cell(BENCH, cell)
    res = pt.trace_cell(BENCH, c, 2**31 + 77, 0.2, "cpu", overrides=SMALL[c["config"]])
    assert res["correct"] and res["calls"] > 0
    assert set(res["readings"]) == READS[cell]
    assert all(v >= 0 for v in res["readings"].values())
    if cell == "fusion-1080p.night":
        assert res["readings"]["bayes_decide_queued_pct"] == pytest.approx(
            res["rule_queued_pct"], abs=0.01)
        assert res["program"]["span_ms"]["op.launch"] <= res["program"]["span_ms"]["op.bayes_decide"]
    else:
        parts = sum(res["readings"][k] for k in ("decide_upload_ms", "decide_sweep_ms",
                                                 "decide_assemble_ms"))
        assert parts <= res["program"]["span_ms"]["net.decide"]
        assert res["outside"]["decide_host_ms.window"] >= res["program"]["span_ms"]["net.decide"]


def test_untraced_program_reads_nothing():
    c = harness.find_cell(BENCH, "fusion-1080p.night")
    res = pt.trace_cell(BENCH, c, 9, 0.1, "cpu", program_trace=False,
                        overrides=SMALL[c["config"]])
    assert res["correct"] and res["readings"] == {} and res["program"]["counters"] == {}
    assert "ops_host_ms.fusion" in res["outside"]
