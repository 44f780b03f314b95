"""The port's configs (``repro_torch.configs``) against the reference's, and the
port's model init on torch's ``meta`` device against ``jax.eval_shape`` of the
reference's init.

Configs are equal field for field (``dataclasses.asdict``) with the same
``param_count``; meta-device leaves have the reference's shapes and dtypes
exactly, and nothing is allocated.  deepseek-v3's full init is traced at its
full width cut to one and two MoE repetitions (tracing its 58 repetitions of
768 expert draws takes the reference 46 s here); each leaf of a repetition
has the full config's shape, and the full count follows from the two cuts.
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


def _stacked(keystr):
    return keystr.startswith(("['blocks']", "['enc_blocks']", "['dec_blocks']"))


def _meta_matches_eval_shape(cfg, jcfg):
    """Every leaf on ``meta``: the reference's shape and dtype (a stacked leaf
    is one leaf per repetition or layer here).  Returns the reference's count."""
    want = jax.eval_shape(lambda k: japi.init(jcfg, k), jax.random.PRNGKey(0))
    model = api.init(cfg, KEY, device="meta")
    got = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in got.values())
    seen = 0
    for path, leaf in jtu.tree_leaves_with_path(want):
        ks = jtu.keystr(path)
        stacked = _stacked(ks)
        for r in range(leaf.shape[0]) if stacked else [None]:
            p = got[convert.state_dict_key(ks, r)]
            assert tuple(p.shape) == (leaf.shape[1:] if stacked else leaf.shape), ks
            assert p.dtype == _torch_dtype(leaf.dtype), ks
            seen += 1
    assert seen == len(got)
    count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    assert api.param_count(model) == count
    return count


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS if a != "deepseek-v3-671b"])
def test_meta_init_matches_eval_shape(arch):
    """The full config, every leaf, on ``meta``."""
    _meta_matches_eval_shape(T.get_config(arch), R.get_config(arch))


def test_meta_init_matches_eval_shape_deepseek_at_full_width():
    """deepseek-v3 at full width, its 3 dense MLA prefix layers and 1 or 2
    MoE repetitions (MTP head included); the full config's count from them."""
    arch = "deepseek-v3-671b"
    counts = [_meta_matches_eval_shape(
        dataclasses.replace(T.get_config(arch), num_layers=3 + reps),
        dataclasses.replace(R.get_config(arch), num_layers=3 + reps)) for reps in (1, 2)]
    full = T.get_config(arch)
    n_reps = full.num_layers - len(full.prefix_kinds)
    assert api.param_count(api.init(full, KEY, device="meta")) == \
        counts[0] + (n_reps - 1) * (counts[1] - counts[0])
