"""Expert parallelism, the sharded loss, ``compressed_mean`` and ``constrain``
on a (2, 2) ("data", "model") gloo world, held against the JAX reference.

One world (``tests/torch_dist.py::models``) runs everything; the tests read
its results.  The bounds are the reference's own where it states one
(``tests/distributed/test_multidevice.py``): the MoE EP path within
atol/rtol 5e-4 of the local path, the sharded loss within rtol 2e-2 of the
plain loss; ``compressed_mean`` is bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.models import moe as r_moe
from repro.optim import compression as r_compression

from torch_dist import run_world

pytestmark = pytest.mark.dist

# the sharded loss against the port's own unsharded loss: bf16 params, and the
# sharded matmuls sum their partial products in another order
LOSS_RTOL = 1e-3


def _moe_cfg():
    cfg = r_smoke("llama4-scout-17b-a16e")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=8,
                                                            capacity_factor=8.0))


def _lm_cfg():
    return dataclasses.replace(r_smoke("qwen2-72b"), d_model=64, num_heads=4, num_kv_heads=4)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref():
    mcfg = _moe_cfg()
    mp = r_moe.moe_init(jax.random.PRNGKey(2), mcfg, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 8, mcfg.d_model), jnp.float32)
    out_local, aux = r_moe.moe_apply(mp, x, mcfg)
    logits = x.reshape(-1, mcfg.d_model).astype(jnp.float32) @ mp["router"]
    ids = r_moe._router_probs(logits, mcfg.moe.router, mcfg.moe.top_k)[1]
    cfg = _lm_cfg()
    params = r_api.init(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size)
    loss, _ = r_api.loss(params, cfg, {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)})
    grad = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (8, 32)) * 0.01, np.float32)
    mcfg_lm = r_smoke("llama4-scout-17b-a16e")
    mtok = tokens % mcfg_lm.vocab_size
    moe_loss, moe_metrics = r_api.loss(r_api.init(mcfg_lm, jax.random.PRNGKey(0)), mcfg_lm,
                                       {"tokens": mtok, "labels": jnp.roll(mtok, -1, 1)})
    return {"moe_lm": float(moe_loss), "moe_lm_nll": float(moe_metrics["nll"]),"moe_params": _flat(mp, "moe."), "moe_x": np.asarray(x),
            "moe_local": np.asarray(out_local), "moe_ids": np.asarray(ids),
            "moe_aux": np.asarray(aux), "tokens": np.asarray(tokens, np.int32),
            "loss": float(loss), "grad": grad}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return run_world("models", 4, tmp_path_factory.mktemp("models"), moe_x=ref["moe_x"],
                     lm_tokens=ref["tokens"], grad=ref["grad"], **ref["moe_params"])


def test_mesh_coordinates_are_row_major(ranks):
    assert [r["coord"].tolist() for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_moe_expert_ids_equal_reference(ranks, ref):
    for got in ranks:
        np.testing.assert_array_equal(got["moe.ids"], ref["moe_ids"])


def test_moe_local_path_equals_reference(ranks, ref):
    for got in ranks:
        np.testing.assert_allclose(got["moe.local"], ref["moe_local"], atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(got["moe.aux_local"], ref["moe_aux"], rtol=1e-6)


def test_moe_expert_parallel_equals_local_and_reference(ranks, ref):
    """The EP path under the mesh gives every rank the global output."""
    for got in ranks:
        np.testing.assert_allclose(got["moe.ep"], got["moe.local"], atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(got["moe.ep"], ref["moe_local"], atol=5e-4, rtol=5e-4)
        assert np.isfinite(got["moe.aux_ep"]).all()


def test_moe_ep_aux_is_the_batch_shards(ranks):
    """aux is averaged over `model` only: ranks of one data shard agree."""
    by_data = {}
    for got in ranks:
        by_data.setdefault(int(got["coord"][0]), []).append(float(got["moe.aux_ep"]))
    for vals in by_data.values():
        assert vals[0] == vals[1]


def test_sharded_loss_within_reference_bound(ranks, ref):
    for got in ranks:
        np.testing.assert_allclose(float(got["lm.sharded"]), ref["loss"], rtol=2e-2)
        np.testing.assert_allclose(float(got["lm.plain"]), ref["loss"], rtol=2e-2)


def test_sharded_loss_close_to_port_plain_loss(ranks):
    for got in ranks:
        np.testing.assert_allclose(float(got["lm.sharded"]), float(got["lm.plain"]),
                                   rtol=LOSS_RTOL)
    assert len({float(g["lm.sharded"]) for g in ranks}) == 1


def test_sharded_moe_loss_takes_the_ep_path(ranks, ref):
    """llama4-scout's smoke model under the mesh: its MoE layers run expert
    parallel on DTensor activations.  The nll is held like the dense loss;
    the total carries 0.01 aux, which the EP path takes per batch shard, as
    the reference's does, so it is held at the reference's bound."""
    for got in ranks:
        np.testing.assert_allclose(float(got["moe_lm.sharded_nll"]),
                                   float(got["moe_lm.plain_nll"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got["moe_lm.plain_nll"]), ref["moe_lm_nll"], rtol=2e-2)
        np.testing.assert_allclose(float(got["moe_lm.sharded"]), ref["moe_lm"], rtol=2e-2)
        np.testing.assert_allclose(float(got["moe_lm.plain"]), ref["moe_lm"], rtol=2e-2)


def test_loss_logits_are_vocab_sharded(ranks):
    """The loss's logits are pinned ("batch", None, "model"): the batch over
    `data` and the vocab over `model`, as the reference pins them."""
    calls = [c.split("|") for c in ranks[0]["lm.constrain"].tolist()]
    # the logits' call by its shape, (8, 16) tokens by the padded vocabulary:
    # the attention pins its projections with the same spec, heads over `model`
    logits = [c for c in calls if c[0] == "('batch', None, 'model')" and c[1] == "(8, 16, 512)"]
    assert len(logits) == 1, calls
    assert logits[0][2] == "('S(0)', 'S(2)')", logits
    embed = [c for c in calls if c[0] == "('batch', None, None)"]
    assert embed and embed[0][2] == "('S(0)', 'R')", calls


def test_compressed_mean_bit_for_bit(ranks, ref):
    """Per rank: the reference's compress of that rank's data shard, codes
    summed over `data` in float32, times the rank's own scale over n."""
    g = ref["grad"]
    rows = g.shape[0] // 2
    enc = []
    for d in range(2):
        q, s, res = r_compression.compress(jax.random.PRNGKey(0), {"w": jnp.asarray(g[d * rows:(d + 1) * rows])},
                                           {"w": jnp.zeros((rows, g.shape[1]))})
        enc.append((np.asarray(q["w"]), np.float32(s["w"]), np.asarray(res["w"])))
    total = sum(q.astype(np.float32) for q, _, _ in enc)
    for got in ranks:
        d = int(got["coord"][0])
        want = total * enc[d][1] / np.float32(2)
        np.testing.assert_array_equal(got["cm.mean"], want)
        np.testing.assert_array_equal(got["cm.res"], enc[d][2])
    assert not np.array_equal(ranks[0]["cm.mean"], ranks[2]["cm.mean"])


@pytest.mark.parametrize("tag, want", [
    ("batch_vocab", ["S(0)", "S(2)"]),
    ("unknown_axis", ["R", "S(2)"]),
    ("indivisible", ["R", "R"]),
    ("used_twice", ["S(0)", "S(2)"]),
    ("tuple", ["S(0)", "S(0)"]),
    ("replicate", ["R", "R"]),
])
def test_constrain_fallbacks(ranks, tag, want):
    for got in ranks:
        assert got[f"c.{tag}"].tolist() == want


def test_sharded_gradients_equal_the_unsharded_ones(ranks):
    # float32 weights, the shards' partial sums added in another order than
    # the plain backward's: each leaf within 1e-4 of its largest value
    # (the bound the float32 gradients keep against the reference, ROADMAP)
    for r in ranks:
        loss_plain, loss_sharded = r["step.loss"]
        assert abs(loss_sharded - loss_plain) <= 1e-5 * abs(loss_plain)
        assert float(r["step.grad_err"]) <= 1e-4


def test_adamw_on_each_ranks_shards_equals_the_plain_update(ranks):
    for r in ranks:
        assert r["adamw.equal"].tolist() == [True, True, True, True]
        plain, sharded = r["adamw.gnorm"]
        assert abs(sharded - plain) <= 1e-6 * plain
        # each rank updated its shards in place: the new params keep the placements
        assert len(r["adamw.placements"]) > 1


def test_backward_on_another_thread_equals_the_callers(ranks):
    # a recomputed block re-enters the mesh, and implicit replication is on
    # for the thread that runs the backward
    assert all(bool(r["step.thread_equal"]) for r in ranks)
