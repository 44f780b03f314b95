"""The GPipe pipeline over `pod` of a (4, 2) ("pod", "data") gloo world ==
the reference's sequential stage application, on the reference test's
4-stage residual MLP (``tests/distributed/test_pipeline.py``): d=16, 6
microbatches of 4, within 1e-5; also 1 and 3 microbatches, and 2 stages over
`data`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed.pipeline import reference_forward as r_reference_forward

from torch_dist import run_world

pytestmark = pytest.mark.dist

D, M, B = 16, 6, 4
MICRO = (1, 3, M)
AXES = (("pod", 4), ("data", 2))   # (axis, stages)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    params = {
        "w1": jnp.stack([jax.random.normal(k, (D, 2 * D)) * 0.1 for k in ks]),
        "w2": jnp.stack([jax.random.normal(k, (2 * D, D)) * 0.1 for k in ks]),
    }
    x = jax.random.normal(jax.random.PRNGKey(1), (M, B, D))

    def stage_fn(p, h):
        return h + jax.nn.gelu(h @ p["w1"]) @ p["w2"]

    want = {}
    for axis, stages in AXES:
        sub = {k: v[:stages] for k, v in params.items()}
        for m in MICRO:
            want[f"{axis}.{m}"] = np.asarray(r_reference_forward(stage_fn, sub, x[:m]))
    ranks = run_world("pipeline", 8, tmp_path_factory.mktemp("pipeline"), x=np.asarray(x),
                      w1=np.asarray(params["w1"]), w2=np.asarray(params["w2"]))
    return want, ranks


def test_ranks_cover_the_mesh(case):
    _, ranks = case
    assert sorted(tuple(r["coord"].tolist()) for r in ranks) == \
        [(p, d) for p in range(4) for d in range(2)]


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("axis", [a for a, _ in AXES])
def test_every_rank_returns_the_pipelined_outputs(case, axis, m):
    want, ranks = case
    for got in ranks:
        assert got[f"{axis}.{m}.pipe"].shape == (m, B, D)
        np.testing.assert_allclose(got[f"{axis}.{m}.pipe"], want[f"{axis}.{m}"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("axis", [a for a, _ in AXES])
def test_port_oracle_equals_reference_oracle(case, axis, m):
    want, ranks = case
    for got in ranks:
        np.testing.assert_allclose(got[f"{axis}.{m}.ref"], want[f"{axis}.{m}"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("axis", [a for a, _ in AXES])
def test_pipeline_equals_port_oracle_exactly(case, axis, m):
    """The stages run the same float ops per microbatch in both orders."""
    _, ranks = case
    for got in ranks:
        np.testing.assert_array_equal(got[f"{axis}.{m}.pipe"], got[f"{axis}.{m}.ref"])
