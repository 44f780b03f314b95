"""The benchmark's frozen references and counts against the program's plain CPU
versions, at small sizes: bit for bit where the answers are integers, within
``fusion_map``'s stated tolerance where they are floats."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "src"))

from portbench import traffic as gen  # noqa: E402
from portbench.counts import operators, sweep as sweep_counts  # noqa: E402
from portbench.entries.sweep import port_spec  # noqa: E402
from portbench.reference import fusion, networks, sweep  # noqa: E402

CONFIGS = REPO / "portbench" / "configs"
NETS = json.loads((CONFIGS / "scenarios-4096.json").read_text())["networks"]
KEY = np.array([0x2545F497, 0xFFFFFFF0], np.uint32)


def _maps(seed, m, r, k, scales):
    return gen.class_posteriors(seed, 0, (m, r, k), scales, "cpu")


@pytest.mark.parametrize("m,r,k,n_bits", [(2, 96, 16, 128), (3, 40, 5, 64), (1, 33, 4, 256)])
def test_decide_rows_equals_bayes_decide(m, r, k, n_bits):
    from repro_torch.kernels import bayes_decide

    p = _maps(5, m, r, k, [1.5] * m)
    p[0, :3] = torch.tensor([0.0, 1.0, 0.5])[:, None].expand(3, k)   # levels 0, 256 and a half step
    dec, cnt = bayes_decide(KEY, p, n_bits, device="cpu")
    rows = torch.arange(r)
    want_dec, want_cnt = fusion.decide_rows(p, rows, KEY, n_bits, block=17)
    assert torch.equal(dec, want_dec) and torch.equal(cnt, want_cnt)
    some = torch.tensor([r - 1, 0, r // 2])
    d, c = fusion.decide_rows(p, some, KEY, n_bits)
    assert torch.equal(d, dec[some]) and torch.equal(c, cnt[some])


def test_control_changes_the_decision():
    p = _maps(6, 2, 512, 16, [1.5, 3.0])
    rows = torch.arange(512)
    want = fusion.decide_rows(p, rows, KEY, 128)
    ctrl = fusion.decide_rows(p, rows, KEY, 128, "bfloat16")
    assert int(((want[0] != ctrl[0]) | (want[1] != ctrl[1]).any(-1)).sum()) > 0


def test_fusion_rows_against_fusion_map():
    from repro_torch.kernels import fusion_map

    p = _maps(7, 2, 300, 16, [1.5, 3.0])
    got = fusion_map(p, device="cpu").to(torch.float64)
    want = fusion.fusion_rows(p, torch.arange(300), block=64)
    assert torch.allclose(got, want, atol=2e-6, rtol=1e-5)
    assert float((fusion.fusion_rows(p, torch.arange(300), "bfloat16") - want).abs().max()) > 1e-4


@pytest.mark.parametrize("net", NETS, ids=[n["name"] for n in NETS])
def test_config_networks_are_the_scenarios(net):
    from repro_torch.bayesnet.scenarios import by_name

    assert port_spec(net) == by_name(net["name"])
    plain = networks.load(net)
    spec = by_name(net["name"])
    assert plain.names == spec.topo_order()


@pytest.mark.parametrize("net", NETS, ids=[n["name"] for n in NETS])
def test_sweep_reference_equals_decide(net):
    from repro_torch.bayesnet import compile_network

    b, n_bits = 48, 256
    plain = networks.load(net)
    ev = gen.sample_evidence(plain, 11, 0, b)
    compiled = compile_network(port_spec(net), n_bits=n_bits, device="cpu")
    post, dec, acc = compiled.decide(KEY, ev)
    frames = np.arange(b)
    numer, denom = sweep.counts(plain, plain.thresholds(), torch.from_numpy(ev),
                                torch.from_numpy(frames), b, n_bits, KEY, block=20)
    want_post, want_dec = sweep.assemble(plain, numer, denom)
    assert np.array_equal(post.numpy(), want_post)
    assert np.array_equal(dec.numpy(), want_dec)
    assert np.array_equal(acc.numpy(), denom)
    assert (denom > 0).mean() > 0.8       # evidence drawn from the joint is mostly seen


@pytest.mark.parametrize("net", NETS, ids=[n["name"] for n in NETS])
def test_sweep_count_is_the_gate_count(net):
    from repro_torch.bayesnet import sweep_plan
    from repro_torch.kernels.net_sweep import record_program

    spec = port_spec(net)
    prog = record_program(sweep_plan(spec, spec.queries, spec.evidence))
    plain = networks.load(net)
    alu, muladd = sweep_counts.ops_per_item(plain, plain.thresholds())
    assert (alu + muladd, alu) == (prog.int_ops_per_word, prog.alu_ops_per_word)


def test_thresholds_match_the_program():
    from repro_torch.core import rng

    for net in NETS:
        for rows in networks.load(net).rows:
            for r in rows:
                assert networks.cdf_thresholds(r) == rng.cdf_thresholds_int(r)
                assert len(networks.cdf_thresholds(r, "dac7")) == len(r) - 1


def test_hashed_share_of_the_smoke_maps():
    """chip_smoke.py's N(0, 3^2) maps read 31.40 % of streams hashed on the card."""
    p = _maps(3, 2, 150_000, 16, [3.0, 3.0])
    share = operators.bayes_decide(p, 128, block=50_000).hashed
    assert abs(share - 0.3140) < 0.003


def test_evidence_follows_the_joint():
    """Ancestral sampling: a binary root's frequency is its prior."""
    net = networks.load(next(n for n in NETS if n["name"] == "pedestrian-night"))
    ev = gen.sample_evidence(net, 4, 0, 200_000)
    night = ev[:, 0].mean()                  # evidence column 0 is the root "night"
    prior = net.rows[net.evidence[0]][0][1]
    assert abs(night - prior) < 0.005
    assert np.array_equal(ev, gen.sample_evidence(net, 4, 0, 200_000))
