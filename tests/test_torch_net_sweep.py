"""The port's fused sweep against the JAX reference, on the CPU.

Plans, plain-version counts, the recorded gate program and compiled-network
posteriors are held bit for bit against ``repro`` computed in this process
(the reference side runs ``net_sweep_ref``, its plain jnp path).  The CUDA
kernel itself is compared with its plain version in ``test_torch_cuda.py``,
which needs no JAX and skips where there is no card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.bayesnet import compile as rcompile
from repro.kernels.net_sweep import net_sweep_ref as jax_net_sweep_ref
import repro_torch.bayesnet as T
from repro_torch.bayesnet import compile as tcompile
from repro_torch.core import prng
from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep import (
    SweepPlan,
    epoch_word_bounds,
    net_sweep,
    plan_from_reference,
    program as P,
    record_program,
)
from repro_torch.kernels.net_sweep.kernel import launch_config

torch.set_num_threads(1)

NAMES = sorted(R.SCENARIOS)
KD = np.array([0x9E3779B9, 0x12345678], np.uint32)


def _noise(kind):
    return {
        "clean": None,
        "nominal": R.NoiseModel.nominal(),
        "scaled2": R.NoiseModel.nominal().scaled(2.0),
        "cycle3": R.NoiseModel.nominal().with_cycle(3),
    }[kind]


def _tnoise(noise):
    return None if noise is None else T.NoiseModel(**dataclasses.asdict(noise))


def _fields(plan):
    return (plan.nodes, plan.evidence, plan.queries, plan.epochs, plan.epoch_rows)


def _plans(name, noise=None, epochs=1):
    rs, ts = R.by_name(name), T.by_name(name)
    rp = rcompile.sweep_plan(rs, rs.queries, rs.evidence, noise=noise, drift_epochs=epochs)
    tp = tcompile.sweep_plan(ts, ts.queries, ts.evidence, noise=_tnoise(noise),
                             drift_epochs=epochs)
    return rs, rp, tp


def _evidence(spec, b, seed):
    r = np.random.default_rng(seed)
    cols = [r.integers(0, spec.card(e), b) for e in spec.evidence]
    return np.stack(cols, 1).astype(np.int32).reshape(b, len(spec.evidence))


# --- plans --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clean", "nominal", "scaled2", "cycle3"])
@pytest.mark.parametrize("name", NAMES)
def test_sweep_plan_equals_reference(name, kind):
    _, rp, tp = _plans(name, _noise(kind))
    assert _fields(tp) == _fields(rp)
    assert _fields(plan_from_reference(*_fields(rp))) == _fields(rp)


@pytest.mark.parametrize("name", NAMES)
def test_perturbed_cdf_rows_equal_reference(name):
    rs, ts = R.by_name(name), T.by_name(name)
    for noise in (None, R.NoiseModel.zero(), R.NoiseModel.nominal(),
                  R.NoiseModel.nominal().scaled(2.0), R.NoiseModel.nominal(seed=4).with_cycle(7)):
        assert T.perturbed_cdf_rows(ts, _tnoise(noise)) == R.perturbed_cdf_rows(rs, noise)
    prog = {n: tuple(tuple(max(0, t - 3) for t in row) for row in rows)
            for n, rows in R.perturbed_cdf_rows(rs, None).items()}
    assert (T.perturbed_cdf_rows(ts, _tnoise(R.NoiseModel.nominal()), program=prog)
            == R.perturbed_cdf_rows(rs, R.NoiseModel.nominal(), program=prog))


def test_legacy_pair_plan_normalises_like_reference():
    nodes = (((), (128,)), ((0,), (64, 200)))
    rp = rcompile.SweepPlan(nodes=nodes, evidence=(0,), queries=(1,))
    tp = SweepPlan(nodes=nodes, evidence=(0,), queries=(1,))
    assert _fields(tp) == _fields(rp)
    with pytest.raises(ValueError):
        SweepPlan(nodes=nodes, evidence=(0,), queries=())


# --- the plain version and the gate program -----------------------------------------

def _lowbias32(x):
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


_SALTS = np.array([0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
                   0x9E3779B9, 0xFF51AFD7, 0xC4CEB9FE, 0x2545F497], np.uint32)


def _interpret(prog, plan, kd, ev, n_bits, frame0, total, decide):
    """A numpy interpreter of the gate program: the gate sequence that the
    generated CUDA body runs (``codegen.emit``), one gate at a time."""
    b, w_words = ev.shape[0], n_bits // 32
    f = np.arange(b, dtype=np.uint64)[:, None]
    w = np.arange(w_words, dtype=np.uint64)[None, :]
    m32 = np.uint64(0xFFFFFFFF)
    pos = (((np.uint64(frame0) + f) * np.uint64(w_words)) + w) & m32
    slots = np.zeros((prog.n_slots, b, w_words), np.uint32)
    counts = np.zeros((b, prog.n_out), np.int64)
    full = np.uint32(0xFFFFFFFF)
    for op, dst, a, c in prog.code.tolist():
        if op == P.BASE:
            off = np.uint64((a * total * w_words) & 0xFFFFFFFF)
            v = _lowbias32(((pos + off) & m32).astype(np.uint32) ^ np.uint32(kd[0]))
        elif op == P.PLANE:
            v = _lowbias32(slots[a] ^ _SALTS[c] ^ np.uint32(kd[1]))
        elif op == P.AND:
            v = slots[a] & slots[c]
        elif op == P.OR:
            v = slots[a] | slots[c]
        elif op == P.XOR:
            v = slots[a] ^ slots[c]
        elif op == P.NOT:
            v = ~slots[a]
        elif op == P.ONES:
            v = np.full((b, w_words), full)
        elif op == P.ZERO:
            v = np.zeros((b, w_words), np.uint32)
        elif op == P.EMASK:
            lo, hi = epoch_word_bounds(w_words, c)[a:a + 2]
            v = np.broadcast_to(np.where((w >= lo) & (w < hi), full, np.uint32(0)),
                                (b, w_words))
        elif op == P.EVMASK:
            v = np.broadcast_to(np.where(((ev[:, a:a + 1] >> c) & 1) == 1, np.uint32(0), full),
                                (b, w_words))
        else:
            assert op == P.OUT
            counts[:, c] += np.unpackbits(slots[a].view(np.uint8), axis=-1).sum(-1, dtype=np.int64)
            continue
        slots[dst] = v
    n_s = plan.n_value_slots
    numer, denom = counts[:, :n_s].astype(np.int32), counts[:, n_s].astype(np.int32)
    if not decide:
        return numer, denom
    decs = []
    for card, off in zip(plan.query_cards, plan.slot_offsets):
        s = numer[:, off:off + card - 1]
        decs.append(np.argmax(np.concatenate([(denom - s.sum(-1))[:, None], s], -1), -1))
    return numer, denom, np.stack(decs, -1).astype(np.int32)


# (name, n_bits, batch, noise kind, drift epochs, frame0, total_frames)
_CASES = (
    [(n, 1024, 16, "clean", 1, 0, None) for n in NAMES]
    + [("intersection-cat", 32, 16, "clean", 1, 0, None),
       ("obstacle-class", 4096, 8, "clean", 1, 0, None),
       ("intersection", 1024, 16, "nominal", 2, 0, None),
       ("intersection-cat", 1024, 16, "nominal", 3, 0, None),
       ("lane-change", 2048, 8, "nominal", 3, 0, None),
       # node offsets n * total * w_words and frame counters wrap 2**32
       ("intersection", 1024, 16, "clean", 1, 2**25 - 7, 2**25 + 9),
       ("obstacle-class", 1024, 8, "nominal", 2, 2**27 + 5, 2**28)]
)
_IDS = [f"{c[0]}-{c[1]}b-B{c[2]}-{c[3]}-E{c[4]}-f{c[5]}" for c in _CASES]


@pytest.mark.parametrize("decide", [False, True])
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_plain_sweep_and_gate_program_bit_exact(case, decide):
    name, n_bits, b, kind, epochs, frame0, total = case
    rs, rp, tp = _plans(name, _noise(kind), epochs)
    ev = _evidence(rs, b, seed=n_bits + b + epochs)
    want = jax_net_sweep_ref(jnp.asarray(KD), jnp.asarray(ev), rp, n_bits,
                             frame0=frame0, total_frames=total, decide=decide)
    got = net_sweep(KD, torch.from_numpy(ev), plan=tp, n_bits=n_bits, frame0=frame0,
                    total_frames=total, decide=decide)
    assert len(got) == len(want) == (3 if decide else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    prog = record_program(tp)
    interp = _interpret(prog, tp, KD, ev, n_bits, frame0,
                        b if total is None else total, decide)
    for g, w in zip(interp, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_gate_program_is_compact_and_cached():
    _, _, tp = _plans("intersection-cat", R.NoiseModel.nominal(), 3)
    prog = record_program(tp)
    assert record_program(tp) is prog
    assert prog.code.dtype == np.int32 and prog.code.shape[1] == 4
    assert prog.n_out == tp.n_value_slots + 1
    outs = prog.code[prog.code[:, 0] == P.OUT]
    assert sorted(outs[:, 3].tolist()) == list(range(prog.n_out))
    # slots are reused: the live working set is far below the instruction count
    assert prog.n_slots < len(prog.code) // 10
    assert prog.int_ops_per_word > len(prog.code)
    assert 0 < prog.alu_ops_per_word < prog.int_ops_per_word


def test_int_ops_count_logic_cones_as_lop3():
    """The bound's work count: a cone of logic gates over at most three
    values is one LOP3 (NOT and constants fold into it); a fourth value
    makes the cone's root an operation of its own."""
    base = [(P.BASE, 0, 0, 0)] + [(P.PLANE, 1 + k, 0, k) for k in range(4)]
    cone = [(P.AND, 5, 1, 2), (P.NOT, 6, 5, 0), (P.ONES, 7, 0, 0), (P.AND, 8, 6, 7),
            (P.XOR, 9, 8, 3), (P.OUT, -1, 9, 0)]
    hash_alu, hash_other = 6 + 4 * 6, 3 + 4 * 2
    assert P._int_ops(base + cone) == (hash_alu + 2 + hash_other + 1, hash_alu + 2)
    wider = cone + [(P.OR, 10, 9, 4), (P.OUT, -1, 10, 1)]
    assert P._int_ops(base + wider) == (hash_alu + 4 + hash_other + 2, hash_alu + 4)


def test_launch_config_fits_shared_memory():
    # shared memory holds only the frames' counts: one frame per block at 4096 bits
    assert launch_config(4, 128) == (128, 1, 4 * 4)
    threads, fpb, smem = launch_config(4, 4)
    assert fpb * 4 >= threads and smem == 4 * fpb * 4
    threads, fpb, smem = launch_config(300, 1, 48 * 1024)
    assert threads < 128 and fpb >= threads and smem <= 48 * 1024
    with pytest.raises(ValueError):
        launch_config(10**6, 1)


def test_pick_block_ladder():
    assert backend.pick_block(1024, 128) == 128
    assert backend.pick_block(48, 128) == 8
    assert backend.pick_block(7, 128) == 1


# --- compiled networks ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_compiled_run_and_decide_match_reference(name):
    rs, ts = R.by_name(name), T.by_name(name)
    ev = _evidence(rs, 32, seed=5)
    key = 17
    rnet = R.compile_network(rs, n_bits=512)
    tnet = T.compile_network(ts, n_bits=512, device="cpu")
    rpost, rdec, racc = (np.asarray(x) for x in rnet.decide(
        rcompile.jax.random.PRNGKey(key), ev))
    tpost, tdec, tacc = tnet.decide(prng.PRNGKey(key), ev)
    np.testing.assert_array_equal(tpost.numpy(), rpost)     # float32, exactly
    np.testing.assert_array_equal(tdec.numpy(), rdec)
    np.testing.assert_array_equal(tacc.numpy(), racc)
    post, acc = tnet.run(prng.PRNGKey(key), torch.from_numpy(ev))
    np.testing.assert_array_equal(post.numpy(), rpost)
    np.testing.assert_array_equal(acc.numpy(), racc)
    np.testing.assert_array_equal(T.posterior_argmax(post).numpy(), rdec)
    assert tcompile.network_stats(tnet) == rcompile.network_stats(rnet)


def test_compile_defaults_to_the_card_and_never_falls_back():
    spec = T.by_name("sensor-degradation")
    if torch.cuda.is_available():
        assert T.compile_network(spec, n_bits=64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.compile_network(spec, n_bits=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            backend.resolve_device("cuda")
    with pytest.raises(ValueError):
        backend.resolve_device("meta")


@pytest.mark.parametrize("kwargs", [
    dict(fused=False), dict(share_entropy=True), dict(estimator="fill"),
    dict(mux_mode="rows"), dict(devices=2),
])
def test_unported_lowerings_raise_and_name_the_roadmap(kwargs):
    """What the port still refuses: multi-device launches raise and name
    their ROADMAP item.  The four unfused options compile since the unfused
    lowering was ported (``test_torch_unfused.py`` holds them against the
    reference); with ``devices=2`` each raises the reference's ValueError."""
    spec = T.by_name("lane-change")
    if "devices" in kwargs:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
            T.compile_network(spec, n_bits=64, device="cpu", **kwargs)
        return
    assert not T.compile_network(spec, n_bits=64, device="cpu", **kwargs).fused
    with pytest.raises(ValueError, match="requires the fused lowering"):
        T.compile_network(spec, n_bits=64, device="cpu", devices=2, **kwargs)


def test_compile_validates_like_reference():
    spec = T.by_name("sensor-degradation")
    with pytest.raises(ValueError):
        T.compile_network(spec, n_bits=48, device="cpu")
    with pytest.raises(ValueError):
        T.compile_network(spec, n_bits=64, device="cpu", estimator="median")
    with pytest.raises(ValueError):
        T.compile_network(spec, n_bits=64, device="cpu", drift_epochs=3)
    with pytest.raises(ValueError):
        T.compile_network(spec, n_bits=64, device="cpu", noise=T.NoiseModel(),
                          drift_epochs=3)
    with pytest.raises(TypeError):
        T.compile_network(spec, n_bits=64, device="cpu", noise=0.1)
    net = T.compile_network(spec, n_bits=64, device="cpu")
    with pytest.raises(ValueError):
        net.run(prng.PRNGKey(0), np.zeros((2, len(spec.evidence) + 1), np.int32))
