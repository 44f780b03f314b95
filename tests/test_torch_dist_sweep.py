"""The frame-sharded sweep on gloo worlds, held bit for bit against the JAX
reference's single-device program.

Each world (``tests/torch_dist.py``) compiles every scenario three ways on
every rank -- unsharded, ``devices=N`` and under an ambient mesh -- and runs
``run`` and ``decide`` on the same global evidence.  The reference's own
sharded tests hold its ``shard_map`` launch to its single-device launch; the
port's sharded launch is held here to that same single-device launch.
"""

import jax
import numpy as np
import pytest

from repro.bayesnet import SCENARIOS as R_SCENARIOS
from repro.bayesnet import by_name as r_by_name
from repro.bayesnet import compile_network as r_compile
from repro.bayesnet import sample_evidence as r_sample_evidence

from torch_dist import run_world

pytestmark = pytest.mark.dist

NAMES = sorted(R_SCENARIOS)
N_BITS = 256
BATCH = 16
KEY = np.asarray(jax.random.key_data(jax.random.PRNGKey(0)))
# (ranks, ambient mesh shape, its axis names, the ambient mesh's batch axes)
WORLDS = {"4": (4, (2, 2), ("pod", "data"), "pod/data"),
          "2": (2, (2,), ("data",), "data")}


def _evidence(name):
    return np.asarray(r_sample_evidence(r_by_name(name), jax.random.PRNGKey(1), BATCH), np.int32)


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device run and decide of every scenario."""
    out = {}
    for name in NAMES:
        net = r_compile(r_by_name(name), n_bits=N_BITS)
        ev = _evidence(name)
        key = jax.random.PRNGKey(0)
        p, a = net.run(key, ev)
        pd, d, ad = net.decide(key, ev)
        po, ao = net.run(key, ev[:BATCH - 3])
        out[name] = {"post": p, "acc": a, "dpost": pd, "dec": d, "dacc": ad,
                     "odd.post": po, "odd.acc": ao}
    return {n: {k: np.asarray(v) for k, v in d.items()} for n, d in out.items()}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    n, shape, names, axes = WORLDS[request.param]
    ranks = run_world("sweep", n, tmp_path_factory.mktemp(f"sweep{n}"), key=KEY, n_bits=N_BITS,
                      mesh_shape=np.array(shape), mesh_names=np.array(names),
                      names=np.array(NAMES), **{name: _evidence(name) for name in NAMES})
    return n, axes, ranks


@pytest.mark.parametrize("name", NAMES)
def test_sharded_run_and_decide_equal_reference(world, reference, name):
    """devices=N and the ambient mesh equal the reference bit for bit, on
    every rank, for run and decide; so does the port's unsharded run."""
    n, axes, ranks = world
    want = reference[name]
    for r, got in enumerate(ranks):
        assert got[f"{name}.shards"].tolist() == [n, n], r
        assert got[f"{name}.axes"].tolist() == ["frames", axes], r
        for tag in ("single", "devices", "ambient"):
            for field in ("post", "acc", "dpost", "dec", "dacc"):
                np.testing.assert_array_equal(got[f"{name}.{tag}.{field}"], want[field],
                                              err_msg=f"rank {r} {tag} {field}")


@pytest.mark.parametrize("name", NAMES)
def test_indivisible_batch_runs_unsharded(world, reference, name):
    """A batch the shard count does not divide gives the single-device result."""
    _, _, ranks = world
    for got in ranks:
        np.testing.assert_array_equal(got[f"{name}.odd.post"], reference[name]["odd.post"])
        np.testing.assert_array_equal(got[f"{name}.odd.acc"], reference[name]["odd.acc"])


def test_recalibrated_network_keeps_shards(world):
    """Recalibrating a sharded network keeps its shard count, and every rank
    gets the same posteriors as the reference's recalibrated network."""
    from repro.bayesnet import NoiseModel as RNoise
    from repro.bayesnet import recalibrated_network as r_recal

    n, _, ranks = world
    net = r_compile(r_by_name("intersection"), n_bits=N_BITS, noise=RNoise.nominal())
    want = np.asarray(r_recal(net, 3.0).run(jax.random.PRNGKey(0), _evidence("intersection"))[0])
    for got in ranks:
        assert int(got["recal.shards"]) == n
        np.testing.assert_array_equal(got["recal.post"], want)


def test_shards_past_2_32_words_stitch_to_one_launch(world):
    """Shards whose global frame origins wrap the 32-bit counters, gathered
    in shard order, equal one launch of the whole slice."""
    _, _, ranks = world
    for got in ranks:
        np.testing.assert_array_equal(got["wrap.got"], got["wrap.want"])


def test_example_and_frame_mesh_on_the_world(world):
    """``examples.sharded_sweep.run`` is bit-identical and drains every frame;
    ``frame_mesh`` spans the world and refuses another size."""
    n, _, ranks = world
    for got in ranks:
        assert got["example"].tolist() == [1, 64, n, n]
        assert got["frame_mesh.names"].tolist() == ["frames"]
        assert str(got["frame_mesh.err"]) == \
            f"devices={n + 1} differs from the started world's {n} ranks"
