"""The port's configs (``repro_torch.configs``) against the reference's, and the
port's model init on torch's ``meta`` device against ``jax.eval_shape`` of the
reference's init.

Configs are equal field for field (``dataclasses.asdict``) with the same
``param_count``; meta-device leaves have the reference's shapes and dtypes
exactly, and nothing is allocated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.models import api as japi
from repro_torch import configs as T
from repro_torch.models import api, convert

LM_ARCHS = [a for a in R.ARCH_IDS if a != "paper-bayes-fusion"]
SLICE_ARCHS = ["qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b"]
LATER_ARCHS = [a for a in LM_ARCHS if a not in SLICE_ARCHS]
KEY = np.zeros(2, np.uint32)


def test_arch_ids_and_shapes_equal():
    assert T.ARCH_IDS == R.ARCH_IDS
    assert [dataclasses.asdict(s) for s in T.SHAPES] == [dataclasses.asdict(s) for s in R.SHAPES]
    assert sorted(T.SHAPES_BY_NAME) == sorted(R.SHAPES_BY_NAME)


@pytest.mark.parametrize("arch", R.ARCH_IDS)
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_config_equals_reference(arch, which):
    got, want = getattr(T, which)(arch), getattr(R, which)(arch)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if hasattr(want, "param_count"):
        assert got.param_count() == want.param_count()
        assert got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_unknown_arch_raises_key_error(which):
    with pytest.raises(KeyError, match="unknown arch"):
        getattr(T, which)("gpt-17")


def test_full_configs_construct():
    """Mirror of ``test_smoke_archs.test_full_configs_construct``."""
    expects = {
        "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
        "starcoder2-15b": (40, 6144, 48, 4, 24576, 49152),
        "minitron-4b": (32, 3072, 24, 8, 9216, 256000),
        "phi3-mini-3.8b": (32, 3072, 32, 32, 8192, 32064),
        "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "xlstm-350m": (24, 1024, 4, 4, 0, 50304),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "deepseek-v3-671b": (61, 7168, 128, 128, 18432, 129280),
        "seamless-m4t-large-v2": (48, 1024, 16, 16, 8192, 256206),
    }
    for arch, dims in expects.items():
        cfg = T.get_config(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                cfg.vocab_size) == dims, arch


def _torch_dtype(d):
    return {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[jnp.dtype(d).type]


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_meta_init_matches_eval_shape(arch):
    """Every leaf of the full config, on ``meta``: the reference's shape and
    dtype (a stacked blocks leaf is one leaf per repetition here)."""
    cfg = T.get_config(arch)
    want = jax.eval_shape(lambda k: japi.init(R.get_config(arch), k), jax.random.PRNGKey(0))
    model = api.init(cfg, KEY, device="meta")
    got = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in got.values())
    seen = 0
    for path, leaf in jtu.tree_leaves_with_path(want):
        ks = jtu.keystr(path)
        stacked = ks.startswith("['blocks']")
        for r in range(leaf.shape[0]) if stacked else [None]:
            p = got[convert.state_dict_key(ks, r)]
            assert tuple(p.shape) == (leaf.shape[1:] if stacked else leaf.shape), ks
            assert p.dtype == _torch_dtype(leaf.dtype), ks
            seen += 1
    assert seen == len(got)
    assert api.param_count(model) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))


@pytest.mark.parametrize("arch", LATER_ARCHS)
def test_later_archs_construct_and_their_models_raise(arch):
    """The MoE, MLA, recurrent, xLSTM and audio configs are data and port now;
    their models come with the next slice and raise, naming it."""
    cfg = T.get_config(arch)
    assert cfg.param_count() == R.get_config(arch).param_count()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        api.init(cfg, KEY, device="meta")
