"""The sharded LM path on a (2, 2, 2) ("pod", "data", "model") gloo world,
whose batch is split over two axes, held against the unsharded path and the
JAX reference.

One world (``tests/torch_dist.py::lm``) runs everything; the tests read its
results.  Bounds: the vocab-sharded NLL within 1e-6 of ``log_softmax`` on
the same float32 logits (its sums reduced over the shards in another order),
its gradient within 1e-7; attention with the heads split over `model`
within 1e-6 of the unsharded call (the same float32 ops on fewer heads);
the sLSTM's recurrence on each rank's rows bit for bit (beside the plain
sLSTM on the same rows: a matmul's rounding depends on its row count), the
FFN after it within 1e-6 (float32 matmuls, which DTensor dispatches its own
way); the sharded loss within 1e-5 and
its gradients within 1e-4 of their largest value (the bounds of
``test_torch_dist_models.py``), and the bf16 loss within rtol 2e-2 of the
reference's plain ``api.loss``; prefill and decode logits and each bf16
cache leaf within the LM path's atol 1e-1, rtol 2e-2 of the unsharded ones
(bf16 weights: the sharded matmuls round their partial sums to bf16, and one
ulp of a cache at its magnitude of 4 is 0.03); xlstm's and recurrentgemma's
float32 states within 1e-4 of each leaf's largest value (float32 weights:
their recurrences amplify bf16 roundings, 4 % of a state at bf16); the
RG-LRU's conv and scan on each rank's rows bit for bit beside the plain
RG-LRU on the same rows (the matmuls before them made exact), its output
within 1e-6 and its parameter gradients within 1e-5 of their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api

from torch_dist import run_world

pytestmark = pytest.mark.dist

ARCHS = ("qwen2-72b", "starcoder2-15b", "deepseek-v3-671b", "xlstm-350m", "recurrentgemma-2b")
RECURRENT = ("xlstm-350m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def ref():
    cfg = r_smoke("qwen2-72b")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size)
    loss, _ = r_api.loss(r_api.init(cfg, jax.random.PRNGKey(0)), cfg,
                         {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)})
    rng = np.random.default_rng(0)
    return {"tokens": np.asarray(tokens, np.int32), "loss": float(loss),
            "attn_q": rng.standard_normal((8, 8, 6, 16), np.float32),
            "attn_kv": rng.standard_normal((2, 8, 8, 3, 16), np.float32),
            "slstm_x": rng.standard_normal((8, 6, 32), np.float32),
            "rglru_x": rng.integers(-2, 3, (8, 6, 64)).astype(np.float32) / 4,
            "rglru_conv": rng.integers(-4, 5, (4, 64)).astype(np.float32) / 8,
            "logits": rng.standard_normal((8, 8, 64), np.float32) * 4,
            "labels": rng.integers(0, 64, (8, 8)).astype(np.int32)}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return run_world("lm", 8, tmp_path_factory.mktemp("lm"), lm_tokens=ref["tokens"],
                     **{k: ref[k] for k in ("attn_q", "attn_kv", "slstm_x", "rglru_x", "rglru_conv",
                                             "logits", "labels")})


def test_mesh_coordinates_are_row_major(ranks):
    assert [r["coord"].tolist() for r in ranks] == \
        [[p, d, m] for p in range(2) for d in range(2) for m in range(2)]


def test_vocab_sharded_nll_equals_log_softmax(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["nll.sharded"], r["nll.plain"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["nll.sharded_grad"], r["nll.plain_grad"], rtol=0, atol=1e-7)
        # placed as the labels: the rows split over pod and data, whole over model
        assert r["nll.placements"].tolist() == ["S(0)", "S(0)", "R"]


@pytest.mark.parametrize("kvh", [2, 3, 1])
def test_head_sharded_attention_equals_replicated(ranks, kvh):
    """6 query heads over `model` = 2: KV heads 2 (each rank its block), 3
    (groups split unevenly: each rank's slice repeated to its 3 heads) and 1
    (one slice)."""
    for r in ranks:
        np.testing.assert_allclose(r[f"attn{kvh}.sharded"], r[f"attn{kvh}.plain"],
                                   rtol=1e-6, atol=1e-6)
        assert r[f"attn{kvh}.placements"].tolist() == ["S(0)", "S(0)", "S(2)"]
        assert int(r[f"attn{kvh}.local_heads"]) == 3


@pytest.mark.parametrize("tag", ["seq", "step"])
def test_slstm_on_each_ranks_rows_is_bit_exact(ranks, tag):
    for r in ranks:
        got, want = r[f"slstm.{tag}.sharded"], r[f"slstm.{tag}.plain"]
        np.testing.assert_array_equal(got[1:], want[1:])       # the state c, n, m, h
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_vocab_sharded_loss_and_gradients(ranks, ref):
    for r in ranks:
        plain, sharded = r["loss.f32"]
        assert abs(sharded - plain) <= 1e-5 * abs(plain)
        assert float(r["loss.grad_err"]) <= 1e-4
        np.testing.assert_allclose(float(r["loss.bf16_sharded"]), ref["loss"], rtol=2e-2)
        np.testing.assert_allclose(float(r["loss.bf16_plain"]), ref["loss"], rtol=2e-2)
        # three all-reduces over `model` of one value per row, counted by StepCounter
        assert int(r["loss.all_reduces"]) >= 3


def test_sharded_step_holds_no_global_logits(ranks):
    # the smoke qwen2's float32 logits: (8, 16, 512) x 4 bytes
    for r in ranks:
        assert int(r["loss.largest_bytes"]) < 8 * 16 * 512 * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode(ranks, arch):
    for r in ranks:
        plain, sharded = r[f"{arch}.logits"]
        np.testing.assert_allclose(sharded, plain, rtol=2e-2, atol=1e-1)
        plain, sharded = r[f"{arch}.step"]
        np.testing.assert_allclose(sharded, plain, rtol=2e-2, atol=1e-1)
        for err, big, bf16 in r[f"{arch}.cache_err"]:
            assert err <= (1e-1 + 2e-2 * big if bf16 else 1e-4 * big)
        # the caches written in place keep sharding.place_state's placement (a
        # recurrent state is its recurrence's result, placed as it comes)
        assert r[f"{arch}.cache_placed"].all() or arch in RECURRENT


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-72b", "deepseek-v3-671b"])
def test_sharded_prefill_state_holds_no_storage_past_its_block(ranks, arch):
    """Each leaf of the state a sharded prefill returns lies in a storage of
    its own block's size: no view into a sequence-long tensor."""
    for r in ranks:
        block, storage = r[f"{arch}.state_storage"].T
        assert (storage == block).all(), r[f"{arch}.state_storage"]


@pytest.mark.parametrize("tag", ["seq", "step"])
def test_rglru_on_each_ranks_rows_is_bit_exact(ranks, tag):
    """The conv and the scan on each rank's block equal the plain RG-LRU on
    the same rows bit for bit (inputs and weights on dyadic grids, so the
    matmuls before them are exact): its state (conv, h); the output after
    the out-projection within 1e-6.  The state is a tensor of its block's
    size."""
    for r in ranks:
        for k in ("conv", "h"):
            want, got = r[f"rglru.{tag}.{k}"]
            np.testing.assert_array_equal(got, want)
            storage, block = r[f"rglru.{tag}.{k}.storage"]
            assert storage == block
        want, got = r[f"rglru.{tag}.out"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rglru_parameter_gradients_sum_over_the_rows(ranks):
    """The conv kernel and the decay, used on each rank's rows, take the
    gradient summed over the batch shards (within 1e-5 of each leaf's
    largest value; float32)."""
    for r in ranks:
        assert float(r["rglru.grad_err"]) <= 1e-5
