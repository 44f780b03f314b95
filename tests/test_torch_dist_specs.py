"""The sharding rules, held against the reference's on every arch's published
config (shapes only: the port on the ``meta`` device, the reference under
``jax.eval_shape``), on 16x16 ("data", "model") and 2x16x16 ("pod", "data",
"model") meshes, with ``POLICY["fsdp2d"]`` off and on.

The reference is called with jax's ``AbstractMesh(axis_sizes, axis_names)``.
Its ``blocks`` (and enc-dec ``enc_blocks`` / ``dec_blocks``) leaves are
stacked over repetitions; each of the port's repetitions must carry the
stacked spec without its leading dim.
"""

import contextlib

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as r_get_config
from repro.distributed import sharding as r_sharding
from repro.models import api as r_api
from repro.models import transformer as r_transformer

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.distributed import sharding
from repro_torch.models import api, convert, transformer

pytestmark = pytest.mark.dist

ARCHS = ("qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b",
         "recurrentgemma-2b", "xlstm-350m", "llama4-scout-17b-a16e", "deepseek-v3-671b",
         "seamless-m4t-large-v2")
DECODERS = tuple(a for a in ARCHS if a != "seamless-m4t-large-v2")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def policy(fsdp2d):
    old = r_sharding.POLICY["fsdp2d"], sharding.POLICY["fsdp2d"]
    r_sharding.POLICY["fsdp2d"] = sharding.POLICY["fsdp2d"] = fsdp2d
    try:
        yield
    finally:
        r_sharding.POLICY["fsdp2d"], sharding.POLICY["fsdp2d"] = old


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference (keystr, shape) leaves, port model on meta)."""
    out = {}
    for arch in ARCHS:
        rp = jax.eval_shape(lambda c=r_get_config(arch): r_api.init(c, jax.random.PRNGKey(0)))
        flat = jax.tree_util.tree_flatten_with_path(rp)[0]
        out[arch] = ([(p, tuple(v.shape)) for p, v in flat],
                     api.init(get_config(arch), prng.PRNGKey(0), device="meta"))
    return out


@pytest.mark.parametrize("fsdp2d", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(shapes, arch, mesh_name, fsdp2d):
    sizes, names = MESHES[mesh_name]
    rmesh = AbstractMesh(sizes, names)
    mesh = sharding.MeshShape(sizes, names)
    leaves, model = shapes[arch]
    with policy(fsdp2d):
        got = sharding.param_specs(model, mesh)
        members = dict(convert.reference_leaves(got))
        assert len(members) == len(leaves)
        n_sharded = 0
        for path, shape in leaves:
            want = _padded(r_sharding.spec_for_leaf(path, shape, rmesh), len(shape))
            group = members[jax.tree_util.keystr(path)]
            stacked = group[0][0] is not None
            for _, key in group:
                assert got[key] == (want[1:] if stacked else want), (key, shape, want)
            n_sharded += any(e is not None for e in want)
            for dim, ax in enumerate(want):   # every axis divides its dim
                axes = ax if isinstance(ax, tuple) else (ax,)
                if ax is not None:
                    assert shape[dim] % int(np.prod([dict(zip(names, sizes))[a] for a in axes])) == 0
        assert n_sharded > 0


@pytest.mark.parametrize("batch", [32, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DECODERS)
def test_state_specs_equal_reference(arch, mesh_name, batch):
    sizes, names = MESHES[mesh_name]
    rcfg, cfg = r_get_config(arch), get_config(arch)
    t_cache = 256
    rstate = jax.eval_shape(lambda: r_transformer.init_decode_state(rcfg, batch, t_cache))
    want = r_sharding.state_specs_for_cache(rstate, AbstractMesh(sizes, names))
    state = transformer.init_decode_state(cfg, batch, t_cache, device="meta")
    got = sharding.state_specs_for_cache(state, sharding.MeshShape(sizes, names))

    def spec_of(sh, shape):
        return _padded(sh.spec, len(shape))

    for i, (g, s) in enumerate(zip(got["prefix"], state["prefix"])):
        for leaf in s:
            ref_leaf = rstate["prefix"][i][leaf]
            assert g[leaf] == spec_of(want["prefix"][i][leaf], ref_leaf.shape), leaf
    for pos, reps in enumerate(got["blocks"]):
        for r, rep in enumerate(reps):
            for leaf, spec in rep.items():
                ref_leaf = rstate["blocks"][pos][leaf]
                assert spec == spec_of(want["blocks"][pos][leaf], ref_leaf.shape)[1:], \
                    (pos, r, leaf)
                assert len(spec) == len(state["blocks"][pos][r][leaf].shape)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = sharding.MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements(("model", ("pod", "data"), None), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), mesh)


def test_batch_axes_follow_the_reference():
    for sizes, names in [((4,), ("frames",)), ((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))]:
        for fsdp2d in (False, True):
            with policy(fsdp2d):
                assert sharding.batch_axes(sharding.MeshShape(sizes, names)) == \
                    tuple(r_sharding.batch_axes(AbstractMesh(sizes, names)))
