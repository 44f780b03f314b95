"""The port's decision path and fusion operators under a tracer (CPU).

Traced calls return what untraced ones return, bit for bit, and record their
spans in order; untraced calls touch neither the tracer nor
``torch.profiler``; ``bayes_decide`` counts the streams it queues for hashing
by the thresholds rule.
"""

import numpy as np
import pytest
import torch

from repro_torch.bayesnet import SCENARIOS, by_name, compile_network
from repro_torch.bayesnet.analytic import sample_evidence
from repro_torch.core import prng
from repro_torch.kernels import bayes_decide, fusion_map
from repro_torch.obs import Tracer

NETS = sorted(SCENARIOS)
KEY = np.array([0x9E3779B9, 0x12345678], np.uint32)
N_BITS, FRAMES = 256, 64


def _net(name, trace=None):
    return compile_network(by_name(name), n_bits=N_BITS, device="cpu", trace=trace)


def _evidence(name):
    return sample_evidence(by_name(name), prng.PRNGKey(5), FRAMES, device="cpu").numpy()


def _maps(scales, shape=(2, 3, 17, 16), seed=0):
    """(M, ..., K) softmax class maps of N(0, scales[m]^2) logits."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(shape, generator=g) * torch.tensor(scales).view(-1, 1, 1, 1)
    return torch.softmax(logits, dim=-1)


def _rule(p) -> int:
    """Streams with no modality at DAC level 0 and some modality below 256."""
    t = np.clip(np.round(np.asarray(p, np.float32).reshape(p.shape[0], -1, p.shape[-1])
                         * np.float32(256)), 0, 256)
    return int(((t > 0).all(0) & (t < 256).any(0)).sum())


@pytest.mark.parametrize("call", ["decide", "run"])
@pytest.mark.parametrize("name", NETS)
def test_traced_network_is_bit_identical_and_spans_its_parts(name, call):
    tr = Tracer()
    plain, traced = _net(name), _net(name, trace=tr)
    assert traced == plain and traced.trace is tr and plain.trace is None
    ev = _evidence(name)
    want = getattr(plain, call)(KEY, ev)
    got = getattr(traced, call)(KEY, ev)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    spans = tr.spans[1:]                  # after compile_network's own
    assert [s.name for s in spans] == [f"net.{call}", "net.upload", "net.sweep", "net.assemble"]
    top = spans[0]
    assert top.parent_id is None and all(s.parent_id == top.span_id for s in spans[1:])
    assert all(s.done for s in tr.spans)
    assert top.attrs == {"network": name, "frames": FRAMES}
    assert spans[1].attrs == {"bytes": ev.size * 4, "pinned": False}
    assert all(a.t_end <= b.t_start for a, b in zip(spans[1:], spans[2:]))


def _op_call(op, trace=None):
    p = _maps((1.5, 3.0))
    if op == "bayes_decide":
        return bayes_decide(KEY, p, 128, device="cpu", trace=trace)
    return (fusion_map(p, device="cpu", trace=trace),)


@pytest.mark.parametrize("op", ["bayes_decide", "fusion_map"])
def test_traced_operator_is_bit_identical_and_spans_its_parts(op):
    tr = Tracer()
    want, got = _op_call(op), _op_call(op, trace=tr)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    spans = tr.spans
    assert [s.name for s in spans] == [f"op.{op}", "op.prepare", "op.launch"]
    assert spans[0].parent_id is None and all(s.parent_id == 0 for s in spans[1:])
    assert all(s.done for s in spans)
    assert ("bayes_decide.streams" in tr.counters) == (op == "bayes_decide")


@pytest.mark.parametrize("call", ["decide", "run", "bayes_decide", "fusion_map"])
def test_untraced_call_touches_no_tracer_and_no_profiler(call, monkeypatch):
    net = _net("intersection-cat") if call in ("decide", "run") else None

    def refuse(*args, **kwargs):
        raise AssertionError("an untraced call reached the tracer or the profiler")

    for attr in ("span", "begin", "end", "event", "add", "counter"):
        monkeypatch.setattr(Tracer, attr, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse, raising=False)
    if net is not None:
        out = getattr(net, call)(KEY, _evidence("intersection-cat"))
    else:
        out = _op_call(call)
    assert all(isinstance(o, torch.Tensor) for o in out)


@pytest.mark.parametrize("scales", [(1.5, 3.0), (6.0, 3.0)], ids=["night", "day"])
def test_queued_count_follows_the_thresholds_rule(scales):
    p = _maps(scales, seed=3)
    flat = p.reshape(2, -1, 16)
    flat[0, :3] = 0.0                  # dead in one modality
    flat[:, 3:6] = 1.0                 # full in every modality
    flat[1, 6:9, :] = 1.0 / 512        # level 0 after rounding half to even
    tr = Tracer()
    bayes_decide(KEY, p, 64, device="cpu", trace=tr)
    bayes_decide(KEY, p[:, :1], 64, device="cpu", trace=tr)
    want = _rule(p) + _rule(p[:, :1])
    assert 0 < want < p[0].numel()
    assert tr.totals() == {"bayes_decide.queued": want,
                           "bayes_decide.streams": p[0].numel() + p[0, :1].numel()}


def test_tracer_counters_add_and_read_once():
    tr = Tracer()
    tr.add("a", 2)
    tr.add("a", 3)
    c = tr.counter("b", lambda: torch.zeros((), dtype=torch.int64))
    c += 7
    assert tr.counter("b", lambda: pytest.fail("made twice")) is c
    assert tr.totals() == {"a": 5, "b": 7}


def test_annotated_spans_land_in_the_profilers_timeline():
    tr = Tracer(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _op_call("fusion_map", trace=tr)
    names = [e.name for e in prof.events()]
    for want in ("op.fusion_map", "op.prepare", "op.launch"):
        assert names.count(want) == 1
