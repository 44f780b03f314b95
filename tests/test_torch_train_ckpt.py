"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU: the
reference's checkpoint tests mirrored, and each package restoring the
other's checkpoint of ``(params, OptState)`` after a train step, bit for
bit (bf16 travels as float32 and comes back exactly)."""

import json
import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jsmoke
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.models import api, convert
from repro_torch.optim import AdamWConfig, OptState, adamw
from repro_torch.train import make_train_step

torch.set_num_threads(1)


# --------------------------------------- tests/train/test_fault_ckpt.py, mirrored
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 4))}}
    ck.save(5, tree, blocking=True)
    template = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4))}}
    step, restored = ck.restore(template)
    assert step == 5 and restored is template          # restored in place
    assert torch.equal(restored["a"], tree["a"]) and torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_atomic_commit_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((4,))}
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.available_steps() == [3, 4]       # gc keeps last 2
    (tmp_path / "step_9").mkdir()
    (tmp_path / "step_9" / "shard_0.npz").write_bytes(b"junk")
    assert 9 not in ck.available_steps()
    (tmp_path / "_tmp_step_10").mkdir()          # an aborted partial goes at the next commit
    ck.save(5, tree, blocking=True)
    assert not (tmp_path / "_tmp_step_10").exists() and ck.available_steps() == [4, 5]


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.arange(1000, dtype=torch.float32)}
    ck.save(1, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros((4,))}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore({"x": torch.zeros((5,))})
    with pytest.raises(KeyError):
        ck.restore({"y": torch.zeros((4,))})
    # every leaf is checked before any is written: a refused restore leaves the template
    template = {"a": torch.full((4,), 7.0), "x": torch.full((4,), 7.0)}
    with pytest.raises(KeyError):
        ck.restore(template)
    assert torch.equal(template["x"], torch.full((4,), 7.0))


def test_restore_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore({"x": torch.zeros(1)})


def test_restore_casts_to_the_template_dtype_and_defaults_to_the_card(tmp_path):
    """The template places each leaf: its dtype, its device (a template made
    by an entry point lies on the card by default) and its storage."""
    ck = Checkpointer(str(tmp_path))
    x = torch.tensor([1.0, 1.00390625, 3.3], dtype=torch.float32)
    ck.save(1, {"x": x}, blocking=True)
    like = torch.zeros(3, dtype=torch.bfloat16)
    _, r = ck.restore({"x": like})
    assert r["x"] is like and r["x"].dtype == torch.bfloat16
    assert torch.equal(r["x"], x.to(torch.bfloat16))          # round to nearest even
    with pytest.raises(TypeError, match="tensors"):
        ck.restore({"x": np.zeros(3, np.float32)})


# ------------------------------------------------------- (params, OptState)
ARCH = "llama4-scout-17b-a16e"      # blocks stacked over 2 repetitions, MoE leaves, float32 routers
DATA = DataConfig(seed=1, global_batch=4, seq_len=16, vocab_size=get_smoke_config(ARCH).vocab_size)
OPT = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)


def _ref_flat(tree):
    return {jtu.keystr(p): np.asarray(leaf) for p, leaf in jtu.tree_flatten_with_path(tree)[0]}


def _port_state(arch=ARCH):
    """The port's (model, OptState) after one train step from the reference's init."""
    ref = jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(0)))
    model = convert.params_from_reference(ref, get_smoke_config(arch), device="cpu")
    state = adamw.init(model)
    step = make_train_step(get_smoke_config(arch), OPT)
    model, state, _ = step(model, state, batch_at_step(DATA, 0, device="cpu"))
    return ref, model, state


def _port_values(model, state):
    """The port's state as the reference's flat checkpoint keys, as numpy
    (bf16 as float32), built leaf by leaf from the parameter names."""
    out = {}
    for prefix, named in (("[0]", dict(model.named_parameters())), ("[1].step", None),
                          ("[1].master", state.master), ("[1].m", state.m), ("[1].v", state.v)):
        if named is None:
            out[prefix] = state.step.numpy()
            continue
        for key, members in convert.reference_leaves(named):
            arrs = [named[n].detach().float().numpy() if named[n].dtype == torch.bfloat16
                    else named[n].detach().numpy() for _, n in members]
            out[prefix + key] = np.stack(arrs) if members[0][0] is not None else arrs[0]
    return out


def test_port_checkpoint_restored_by_the_reference(tmp_path):
    ref, model, state = _port_state()
    Checkpointer(str(tmp_path / "port")).save(1, (model, state), blocking=True)
    template = (jax.tree.map(jnp.asarray, ref), jadamw.init(jax.tree.map(jnp.asarray, ref)))
    step, (jparams, jopt) = JCheckpointer(str(tmp_path / "port")).restore(template)
    assert step == 1 and int(jopt.step) == 1
    got = _ref_flat((jparams, jopt))
    want = _port_values(model, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == _ref_flat(template)[k].dtype, k
        np.testing.assert_array_equal(np.asarray(got[k], want[k].dtype), want[k], err_msg=k)


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    cfg = jsmoke(ARCH)
    params = japi.init(cfg, jax.random.PRNGKey(0))
    opt = jadamw.init(params)
    jstep = jax.jit(jloop.make_train_step(cfg, jadamw.AdamWConfig(**vars(OPT))))
    params, opt, _ = jstep(params, opt, jpipeline.batch_at_step(jpipeline.DataConfig(**vars(DATA)), 0))
    JCheckpointer(str(tmp_path / "ref")).save(1, (params, opt), blocking=True)

    model = api.init(get_smoke_config(ARCH), prng.PRNGKey(3), device="cpu")
    template = (model, adamw.init(model))
    storage = [p.data_ptr() for p in model.parameters()]
    step, (pmodel, pstate) = Checkpointer(str(tmp_path / "ref")).restore(template)
    assert [p.data_ptr() for p in pmodel.parameters()] == storage     # one copy of the state
    assert step == 1 and isinstance(pstate, OptState) and pmodel is model
    assert pstate.step.dtype == torch.int32 and int(pstate.step) == 1
    assert type(pmodel) is type(model) and pmodel.cfg is model.cfg
    for (n, a), (n2, b) in zip(model.named_parameters(), pmodel.named_parameters(), strict=True):
        assert n == n2 and a.dtype == b.dtype and a.shape == b.shape and b.requires_grad, n
    got = _port_values(pmodel, pstate)
    want = _ref_flat((params, opt))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], got[k].dtype), err_msg=k)
    # the restored model runs
    loss, _ = api.loss(pmodel, get_smoke_config(ARCH), batch_at_step(DATA, 1, device="cpu"))
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "seamless-m4t-large-v2", "deepseek-v3-671b"])
def test_manifests_hold_the_same_leaves(tmp_path, arch):
    """recurrentgemma holds a prefix list, seamless per-layer stacks,
    deepseek a prefix block and an MTP head."""
    cfg = jsmoke(arch)
    params = japi.init(cfg, jax.random.PRNGKey(0))
    JCheckpointer(str(tmp_path / "ref")).save(0, (params, jadamw.init(params)), blocking=True)
    model = api.init(get_smoke_config(arch), prng.PRNGKey(0), device="cpu")
    Checkpointer(str(tmp_path / "port")).save(0, (model, adamw.init(model)), blocking=True)
    leaves = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_0" / "manifest.json") as f:
            leaves[side] = json.load(f)["leaves"]
        with np.load(tmp_path / side / "step_0" / "shard_0.npz") as z:
            assert z.files == list(leaves[side])
    assert list(leaves["port"]) == list(leaves["ref"])       # the same keys, in the same order
    assert leaves["port"] == leaves["ref"]                   # shapes and stored dtypes
    # and the port restores the reference's initial state into its own model
    _, (pmodel, _) = Checkpointer(str(tmp_path / "ref")).restore((model, adamw.init(model)))
    want = convert.params_to_reference(convert.params_from_reference(
        jax.tree.map(np.asarray, params), get_smoke_config(arch), device="cpu"))
    got = convert.params_to_reference(pmodel)
    for (pa, a), (_, b) in zip(jtu.tree_flatten_with_path(want)[0],
                               jtu.tree_flatten_with_path(got)[0]):
        np.testing.assert_array_equal(np.asarray(b, np.float32), np.asarray(a, np.float32),
                                      err_msg=jtu.keystr(pa))
    assert sorted(os.listdir(tmp_path / "port")) == ["step_0"]


def test_float32_params_after_a_microbatched_step_roundtrip(tmp_path):
    """After a microbatched step the params are float32 (the reference's
    promotion); a checkpoint restores them as float32."""
    ref = jax.tree.map(np.asarray, japi.init(jsmoke("qwen2-72b"), jax.random.PRNGKey(0)))
    cfg = get_smoke_config("qwen2-72b")
    model = convert.params_from_reference(ref, cfg, device="cpu")
    state = adamw.init(model)
    data = DataConfig(seed=1, global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
    model, state, _ = make_train_step(cfg, OPT, microbatches=2)(
        model, state, batch_at_step(data, 0, device="cpu"))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, (model, state), blocking=True)
    fresh = convert.params_from_reference(ref, cfg, device="cpu").float()
    _, (m2, s2) = ck.restore((fresh, adamw.init(fresh)))
    for (n, a), (_, b) in zip(model.named_parameters(), m2.named_parameters()):
        assert b.dtype == torch.float32 and torch.equal(a, b), n
    for k in state.m:
        assert torch.equal(state.m[k], s2.m[k]) and torch.equal(state.v[k], s2.v[k])
