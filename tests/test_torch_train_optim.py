"""The port's optimizer (``repro_torch.optim.{adamw,compression}``) against the
live reference, on the CPU.

Tolerances:

* ``schedule``: bit for bit at every step but where torch's float32 ``cos``
  and XLA's round differently: within SCHEDULE_ULP ulp of the value, or one
  ulp of the cosine times ``lr`` where ``1 + cos`` cancels near the end of
  the decay (3 ulp of the value at ``min_lr_ratio=0``);
* ``global_norm``: within NORM_RTOL.  The port sums each leaf's float32
  squares in float64 and rounds the root once; the reference sums in float32
  (at this size it is off the exact value by about 1e-6, relative);
* ``apply`` against the reference run op by op, clipping off: ``m``, ``v``,
  ``master`` and the new params bit for bit over three steps, the params in
  the gradients' dtype.  With clipping on, the clip scale carries the
  global norm's difference (about 1.3e-6) into every leaf: ``m``, ``v`` and
  ``master`` within CLIP_LEAF_REL of each leaf's largest value.  Against the
  compiled reference (XLA contracts ``b1 * m + ...`` into an FMA, which
  rounds once where the port rounds twice): ``m``, ``v`` and ``master``
  within JIT_LEAF_REL of each leaf's largest value (about one ulp of it;
  measured 1.1e-7), the bf16 params equal but where the master lies at a
  rounding boundary (JIT_PARAM_SHARE of them, by one bf16 ulp);
* ``compress``: the int8 values, the scales and the residual bit for bit, on
  a model's stacked tree (two repetitions, an MoE leaf with its expert axis).
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.models import convert
from repro_torch.optim import AdamWConfig, OptState, adamw, compression

torch.set_num_threads(1)

SCHEDULE_ULP = 1
NORM_RTOL = 5e-6
CLIP_LEAF_REL = 1e-5
JIT_LEAF_REL = 4 * 2.0 ** -23
JIT_PARAM_SHARE = 1e-3


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _leaf_rel(got, want):
    """The largest difference over a leaf, relative to the leaf's largest value."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _ref_params(arch):
    return jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(0)))


def _ref_flat(tree):
    return {jtu.keystr(p): np.asarray(leaf) for p, leaf in jtu.tree_flatten_with_path(tree)[0]}


def _port_flat(named):
    """A dict of tensors by parameter name -> {reference keystr: stacked numpy}."""
    out = {}
    for key, members in convert.reference_leaves(named):
        arrs = [named[n].detach().float().numpy() for _, n in members]
        out[key] = np.stack(arrs) if members[0][0] is not None else arrs[0]
    return out


def _grads(ref, seed=0, scale=0.05):
    """Seeded gradients in each leaf's dtype: (reference tree, port dict)."""
    rng = np.random.default_rng(seed)
    gref = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape).astype(np.float32) * scale).astype(x.dtype), ref)
    model = convert.params_from_reference(gref, device="cpu")
    return gref, {n: p.detach().clone() for n, p in model.named_parameters()}


def _setup(arch="qwen2-72b"):
    ref = _ref_params(arch)
    return ref, convert.params_from_reference(ref, get_smoke_config(arch), device="cpu")


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("cfg", [
    AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20),
    AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12, min_lr_ratio=0.0),
    AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=7),
    AdamWConfig(),
], ids=["warm4", "min0", "nowarm", "default"])
def test_schedule_matches_reference(cfg):
    jcfg = jadamw.AdamWConfig(**vars(cfg))
    last = cfg.total_steps + 5 if cfg.total_steps < 100 else 250
    steps = list(range(0, last + 1))
    want = np.array([np.float32(jadamw.schedule(jcfg, jnp.int32(s))) for s in steps])
    got = np.array([adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)).item()
                    for s in steps], np.float32)
    cos_ulp = np.float32(cfg.lr) * np.float32(2.0 ** -23)   # one ulp of the cosine, scaled
    assert np.all(np.abs(got - want) <= SCHEDULE_ULP * np.spacing(want) + cos_ulp)
    assert adamw.schedule(cfg, 3).dtype == torch.float32          # a Python int step


def test_schedule_ends():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20, min_lr_ratio=0.1)
    assert adamw.schedule(cfg, 0).item() == 0.0
    assert adamw.schedule(cfg, 4).item() == np.float32(1e-3)
    assert adamw.schedule(cfg, 25).item() == pytest.approx(1e-4, rel=1e-6)


# ---------------------------------------------------------------------- init
def test_init_matches_reference():
    ref, model = _setup("qwen2-72b")
    want = jadamw.init(jax.tree.map(jnp.asarray, ref))
    got = adamw.init(model)
    assert isinstance(got, OptState)
    assert got.step.dtype == torch.int32 and got.step.shape == () and int(got.step) == 0
    names = [n for n, _ in model.named_parameters()]
    for field in ("master", "m", "v"):
        tree = getattr(got, field)
        assert list(tree) == names
        assert all(t.dtype == torch.float32 for t in tree.values())
        w, g = _ref_flat(getattr(want, field)), _port_flat(tree)
        assert list(w) == list(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{field} {k}")
    # the master is a copy: updating it leaves the params alone
    first = names[0]
    got.master[first].add_(1.0)
    assert not torch.equal(got.master[first], dict(model.named_parameters())[first].float())


# --------------------------------------------------------------- global_norm
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v3-671b"])
def test_global_norm(arch):
    ref = _ref_params(arch)
    gref, gport = _grads(ref, seed=3)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, gref)))
    got = adamw.global_norm(gport)
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.item() == pytest.approx(want, rel=NORM_RTOL)
    exact = np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64))) for x in jax.tree.leaves(gref)))
    assert got.item() == np.float32(exact)         # the root of the float64 sum, rounded once


# --------------------------------------------------------------------- apply
def _run_apply(arch, cfg, steps, jit=False, grad_dtype=None):
    ref, model = _setup(arch)
    jstate = jadamw.init(jax.tree.map(jnp.asarray, ref))
    pstate = adamw.init(model)
    japply = jax.jit(jadamw.apply, static_argnums=2) if jit else jadamw.apply
    for s in range(steps):
        gref, gport = _grads(ref, seed=10 + s)
        if grad_dtype is not None:
            gref = jax.tree.map(lambda x: x.astype(grad_dtype), gref)
            gport = {k: v.to(torch.float32) for k, v in gport.items()}
        jp, jstate, jm = japply(jax.tree.map(jnp.asarray, gref), jstate, jadamw.AdamWConfig(**vars(cfg)))
        pp, pstate, pm = adamw.apply(gport, pstate, cfg)
    return (jp, jstate, jm), (pp, pstate, pm)


def test_apply_bit_equal_to_reference_op_by_op():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1e9)
    (jp, js, jm), (pp, ps, pm) = _run_apply("qwen2-72b", cfg, 3)
    assert int(ps.step) == int(js.step) == 3
    assert pm["lr"].item() == np.float32(jm["lr"])
    for field in ("master", "m", "v"):
        w, g = _ref_flat(getattr(js, field)), _port_flat(getattr(ps, field))
        for k in w:
            assert _ulps(g[k], w[k]) == 0, (field, k)
    w, g = _ref_flat(jp), _port_flat(pp)
    for k in w:
        np.testing.assert_array_equal(g[k], np.asarray(w[k], np.float32), err_msg=k)


def test_apply_params_take_the_gradients_dtype():
    """bf16 gradients give bf16 params (float32 leaves stay float32); float32
    gradients -- a microbatched step's -- give float32 params, as in the
    reference."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    for grad_dtype in (None, np.float32):
        (jp, _, _), (pp, _, _) = _run_apply("qwen2-72b", cfg, 1, grad_dtype=grad_dtype)
        want = {k: str(v.dtype) for k, v in _ref_flat(jp).items()}
        got = {}
        for key, members in convert.reference_leaves(pp):
            got[key] = str(pp[members[0][1]].dtype).replace("torch.", "")
        assert got == want
    assert set(want.values()) == {"float32"}


def test_apply_with_clipping_against_reference():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    (jp, js, jm), (pp, ps, pm) = _run_apply("qwen2-72b", cfg, 2)
    assert pm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=NORM_RTOL)
    for field in ("m", "v", "master"):
        w, g = _ref_flat(getattr(js, field)), _port_flat(getattr(ps, field))
        for k in w:
            assert _leaf_rel(g[k], w[k]) <= CLIP_LEAF_REL, (field, k)


@pytest.mark.parametrize("arch", ["qwen2-72b", "llama4-scout-17b-a16e"])
def test_apply_against_compiled_reference(arch):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1e9)
    (jp, js, _), (pp, ps, _) = _run_apply(arch, cfg, 2, jit=True)
    for field in ("m", "v", "master"):
        w, g = _ref_flat(getattr(js, field)), _port_flat(getattr(ps, field))
        for k in w:
            assert _leaf_rel(g[k], w[k]) <= JIT_LEAF_REL, (field, k)
    w, g = _ref_flat(jp), _port_flat(pp)
    diff = sum(int(np.sum(g[k] != np.asarray(w[k], np.float32))) for k in w)
    total = sum(v.size for v in w.values())
    assert diff <= JIT_PARAM_SHARE * total
    for k in w:
        np.testing.assert_allclose(g[k], np.asarray(w[k], np.float32), rtol=2 ** -7, atol=1e-6)


def test_apply_consumes_its_inputs_in_place():
    _, model = _setup("qwen2-72b")
    state = adamw.init(model)
    _, gport = _grads(_ref_params("qwen2-72b"))
    masters = {k: v.data_ptr() for k, v in state.master.items()}
    ptrs = {k: v.data_ptr() for k, v in gport.items()}
    new, state2, metrics = adamw.apply(gport, state, AdamWConfig())
    assert {k: v.data_ptr() for k, v in state2.master.items()} == masters
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    assert set(metrics) == {"grad_norm", "lr"} and int(state2.step) == 1


def test_apply_updates_a_leaf_larger_than_one_slice(monkeypatch):
    """The update runs a slice at a time: slices are the same arithmetic."""
    monkeypatch.setattr(adamw, "_CHUNK", 7)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1e9)
    (jp, js, _), (pp, ps, _) = _run_apply("phi3-mini-3.8b", cfg, 2)
    for field in ("master", "m", "v"):
        w, g = _ref_flat(getattr(js, field)), _port_flat(getattr(ps, field))
        for k in w:
            assert _ulps(g[k], w[k]) == 0, (field, k)


# --------------------------------------------------------------- compression
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen2-72b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_bit_equal_on_a_models_tree(arch, with_residual):
    """llama4's smoke tree stacks two repetitions and holds MoE leaves with
    their expert axis; seamless stacks per layer."""
    ref = _ref_params(arch)
    gref, gport = _grads(ref, seed=5, scale=0.01)
    rref = rport = None
    if with_residual:
        rref, rport = _grads(ref, seed=6, scale=1e-4)
        rref = jax.tree.map(lambda x: np.asarray(x, np.float32), rref)
        rport = {k: v.float() for k, v in rport.items()}
    key = jax.random.PRNGKey(9)
    jq, js, jr = jcompression.compress(key, jax.tree.map(jnp.asarray, gref), rref)
    pq, ps, pr = compression.compress(np.asarray(jax.random.key_data(key)), gport, rport)
    assert set(pq) == set(gport)
    for name, wtree, got in (("q", jq, pq), ("scale", js, ps), ("residual", jr, pr)):
        w, g = _ref_flat(wtree), _port_flat(got)
        assert list(w) == list(g)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k], np.float32), err_msg=f"{name} {k}")
    assert all(q.dtype == torch.int8 for q in pq.values())
    dw, dg = _ref_flat(jcompression.decompress(jq, js)), _port_flat(compression.decompress(pq, ps))
    for k in dw:
        np.testing.assert_array_equal(dg[k], dw[k], err_msg=k)


def test_compression_error_feedback():
    """int8 stochastic compression: unbiased, error feedback shrinks residual
    (tests/train/test_fault_ckpt.py's test, on the port)."""
    key = prng.PRNGKey(0)
    g = {"w": torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (256, 64)) * 0.01))}
    acc = torch.zeros_like(g["w"])
    n = 30
    for i in range(n):
        q, s, _ = compression.compress(prng.fold_in(key, i), g)
        acc = acc + compression.decompress(q, s)["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=2e-4)
    q, s, res = compression.compress(key, g)
    assert float(res["w"].abs().max()) <= float(s["w"]) + 1e-7
    jq, js, jr = jcompression.compress(jax.random.PRNGKey(0), {"w": jnp.asarray(g["w"].numpy())})
    np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
    np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jr["w"]))


def test_compressed_mean_needs_a_mesh():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        compression.compressed_mean(prng.PRNGKey(0), {}, {}, "data")


def test_reference_leaves_follow_the_reference_flatten_order():
    import repro.configs as R

    for arch in [a for a in R.ARCH_IDS if a != "paper-bayes-fusion"]:
        ref = _ref_params(arch)
        model = convert.params_from_reference(ref, get_smoke_config(arch), device="cpu")
        groups = convert.reference_leaves(dict(model.named_parameters()))
        assert [k for k, _ in groups] == list(_ref_flat(ref)), arch
        for key, members in groups:
            for rep, name in members:
                assert convert.state_dict_key(key, rep) == name
                assert convert.keystr(convert.reference_path(name)[0]) == key
