"""The H100-cluster dry run (``repro_torch.launch.dryrun``) held against the
reference's TPU dry run (``repro.launch.dryrun``).

- Exactly equal to the reference: ``LM_ARCHS``, ``LONG_OK``, ``N_PATCH``,
  ``cell_is_runnable``, ``input_specs`` (shapes and byte widths),
  ``reduced_cfg`` and ``apply_variant`` (every variant part) for all ten
  archs and four shapes, and ``model_flops`` on the reference's
  ``jax.eval_shape`` params (deepseek-v3 at full width and 2 repetitions: its
  whole ``eval_shape`` takes a minute here; the formula reads the depth from
  the config).
- On one device, the port's FLOPs of a smoke train step beside XLA's
  ``cost_analysis`` of the reference's unrolled step: the port counts matmul
  FLOPs only (its recompute included, as XLA counts the rematerialised
  forward), XLA also elementwise work, 7-14 % of a smoke step's (d_model 64),
  so the ratio lies in [0.8, 1.0].
- A mini dry run in fake worlds of a (2, 2, 2) pod/data/model mesh, run in
  subprocesses with a timeout, all started together: the three archs of
  ``tests/distributed/test_dryrun_mini.py`` through a train and a decode
  step (FLOPs and collective bytes > 0, no storage as large as the global
  logits), deepseek-v3 through a prefill and xlstm through a train step and
  a prefill (each prefill's cache per rank at most the global cache over
  the batch shards), deepseek-v3 through a train step under a counter that
  records the shapes it sees made and live at the peak (no tensor of all the
  rank's token-expert assignments by D; no attention scores at the peak),
  ``paper-bayes-fusion`` at its smoke size (per pixel: bytes, no
  collective), ``main`` refusing a started process group, and the CLI's
  phi3-mini-3.8b ``train_4k`` cell on the 256-rank world (``ok: true``, the
  reference's keys with two renamed).
  The reference's own ``test_dryrun_mini`` fails under jax 0.9, so none of
  its expectations is taken as truth.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices, for
this process and every later subprocess: the module fixture starts the JAX
backend first (one device) and restores the variable.  ``apply_variant``
sets ``sharding.POLICY`` in both packages; each test resets it.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import api as ref_api
from repro.optim import adamw as ref_adamw
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import prng
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.models import api

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 300
ARCHS = dryrun.LM_ARCHS + ("paper-bayes-fusion",)


@pytest.fixture(scope="module")
def ref():
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


@pytest.fixture(autouse=True)
def policy():
    import repro.distributed.sharding as ref_sharding

    yield
    sharding.POLICY["fsdp2d"] = False
    ref_sharding.POLICY["fsdp2d"] = False


def test_tables_equal_the_reference(ref):
    assert dryrun.LM_ARCHS == ref.LM_ARCHS
    assert dryrun.LONG_OK == ref.LONG_OK
    assert dryrun.N_PATCH == ref.N_PATCH
    for arch in ARCHS:
        for shape in SHAPES:
            assert dryrun.cell_is_runnable(arch, shape.name) == \
                ref.cell_is_runnable(arch, shape.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(ref, arch):
    from repro.configs import SHAPES as REF_SHAPES

    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        got = dryrun.input_specs(arch, shape, get_config(arch))
        want = ref.input_specs(arch, ref_shape, ref_get_config(arch))
        assert {k: (tuple(s.shape), s.dtype.itemsize) for k, s in got.items()} == \
            {k: (tuple(s.shape), jnp.dtype(s.dtype).itemsize) for k, s in want.items()}


@pytest.mark.parametrize("arch", dryrun.LM_ARCHS)
def test_reduced_cfg_equals_the_reference(ref, arch):
    for r in (1, 2, 3):
        assert dataclasses.asdict(dryrun.reduced_cfg(get_config(arch), r)) == \
            dataclasses.asdict(ref.reduced_cfg(ref_get_config(arch), r))


VARIANTS = [("qwen2-72b", v) for v in ("baseline", "nosp", "qchunk256", "mchunk64", "fsdp2d",
                                       "micro4", "nosp+micro2+fsdp2d")] \
    + [("llama4-scout-17b-a16e", "moedense"), ("deepseek-v3-671b", "moedense+qchunk1024")] \
    + [("paper-bayes-fusion", v) for v in ("analytic", "stochastic", "bits256", "rnginside",
                                           "stochastic+bits64+rnginside")]


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_apply_variant_equals_the_reference(ref, arch, variant):
    import repro.distributed.sharding as ref_sharding

    cfg, opts = dryrun.apply_variant(get_config(arch), variant)
    ref_cfg, ref_opts = ref.apply_variant(ref_get_config(arch), variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert opts == ref_opts
    assert sharding.POLICY == ref_sharding.POLICY


def test_unknown_variant_raises_as_in_the_reference(ref):
    for mod, get in ((dryrun, get_config), (ref, ref_get_config)):
        with pytest.raises(ValueError, match="unknown variant component 'bogus'"):
            mod.apply_variant(get("qwen2-72b"), "nosp+bogus")


@pytest.mark.parametrize("arch", dryrun.LM_ARCHS)
def test_model_flops_equal_the_reference(ref, arch):
    from repro.configs import SHAPES as REF_SHAPES

    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if arch == "deepseek-v3-671b":
        cfg, ref_cfg = dryrun.reduced_cfg(cfg, 2), ref.reduced_cfg(ref_cfg, 2)
    params = api.init(cfg, prng.PRNGKey(0), device="meta")
    ref_params = jax.eval_shape(functools.partial(ref_api.init, ref_cfg), jax.random.PRNGKey(0))
    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        assert dryrun.model_flops(cfg, shape, params) == \
            ref.model_flops(ref_cfg, ref_shape, ref_params)


def test_one_device_flops_beside_xla_cost_analysis(ref):
    arch, b, s = "phi3-mini-3.8b", 2, 16
    ref_cfg = dataclasses.replace(ref_get_smoke_config(arch), unroll_layers=True)
    params = jax.eval_shape(functools.partial(ref_api.init, ref_cfg), jax.random.PRNGKey(0))
    opt = jax.eval_shape(ref_adamw.init, params)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32) for k in ("tokens", "labels")}
    cost = jax.jit(ref.make_train_fn(ref_cfg)).lower(params, opt, batch).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    got = dryrun._measure(get_smoke_config(arch), ShapeConfig("mini", s, b, "train"), None, arch,
                          device="cpu")
    assert 0.8 <= got["flops"] / float(cost["flops"]) <= 1.0
    assert got["collective_bytes"] == 0 and got["peak_bytes"] > 0


# ------------------------------------------------------------ mini dry run

MINI = textwrap.dedent("""
    import json, sys
    from torch.utils._pytree import tree_flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer

    arch, kinds = sys.argv[1], sys.argv[2].split(",")
    out = {}
    with dryrun.fake_world(8):
        mesh = make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), device="cpu")
        cfg = get_smoke_config(arch)
        if arch == "paper-bayes-fusion":
            shape = ShapeConfig("train_4k", 4096, 256, "train")
            for variant in ("baseline", "analytic"):
                out[variant] = dryrun._bayes_cell(cfg, dryrun.apply_variant(cfg, variant)[1],
                                                  shape, mesh, arch, device="cpu")
            try:
                dryrun.main(["--arch", "phi3-mini-3.8b", "--device", "cpu"])
            except RuntimeError as e:
                out["refused"] = str(e)
        else:
            shapes = {"train": ShapeConfig("mini", 32, 8, "train"),
                      "prefill": ShapeConfig("mini_prefill", 32, 8, "prefill"),
                      "decode": ShapeConfig("mini_decode", 64, 8, "decode")}
            for kind in kinds:
                out[kind] = dryrun._measure(cfg, shapes[kind], mesh, arch, device="cpu")
            # the prefill's cache at its global size, and the float32 logits of the batch
            state = transformer.init_decode_state(cfg, 8, 32, device="meta")
            out["global_cache_bytes"] = sum(t.numel() * t.element_size()
                                            for t in tree_flatten(state)[0])
            out["global_logits_bytes"] = 8 * 32 * transformer.layers.pad_vocab(cfg.vocab_size) * 4
    print(json.dumps(out))
""")

# deepseek-v3's train step in the same fake world, its smoke widths with a
# 64-token vocabulary (padded to 256) and 80 tokens a row, under
# ``launch.peak.PeakSplit``, which records the shape of every storage it
# sees made and of those live at the peak: the step must make no tensor of
# all its T*k token-expert assignments by D (the MoE gathers only its
# buffer's slots), and hold no attention scores at the peak (every block,
# the dense prefix and the MTP head too, recomputed in the backward)
MINI_PEAK = textwrap.dedent("""
    import dataclasses, json
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.peak import PeakSplit

    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"), vocab_size=64)
    seq = 80
    with dryrun.fake_world(8):
        mesh = make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args = dryrun.build_step(cfg, ShapeConfig("mini", seq, 8, "train"), mesh,
                                           "deepseek-v3-671b", device="cpu")
            split = dryrun.count_step(step, args, mesh,
                                      counter=PeakSplit(mesh, min_bytes=0, step_bytes=0))
    rows = 8 // 4                                    # the batch over pod x data
    assignments = ((rows * seq * cfg.moe.top_k, cfg.d_model), "bfloat16")
    scores = ((rows, cfg.num_heads // 2, seq, seq), "float32")   # the heads over model
    print(json.dumps({"assignments_made": split.shapes[assignments],
                      "scores_made": split.shapes[scores],
                      "scores_at_peak": [m[:2] for _, m in split.at_peak[1] if m].count(scores)}))
""")

CLI = ["-m", "repro_torch.launch.dryrun", "--arch", "phi3-mini-3.8b", "--shape", "train_4k",
       "--mesh", "single", "--device", "cpu", "--out"]
# arch -> the step kinds its world counts
MINI_ARCHS = {"qwen2-72b": "train,decode", "llama4-scout-17b-a16e": "train,decode",
              "recurrentgemma-2b": "train,decode", "paper-bayes-fusion": "",
              "deepseek-v3-671b": "prefill", "xlstm-350m": "train,prefill"}
MINI_LM = ("qwen2-72b", "llama4-scout-17b-a16e", "recurrentgemma-2b")
BATCH_SHARDS = 4              # the (2, 2, 2) mesh's pod x data


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """Each world's output, by arch, and the CLI's cell ("cli"); all started together."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    runs = {arch: [sys.executable, "-c", MINI, arch, kinds] for arch, kinds in MINI_ARCHS.items()}
    runs["cli"] = [sys.executable, *CLI, str(out_dir)]
    runs["deepseek-peak"] = [sys.executable, "-c", MINI_PEAK]
    procs = {k: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for k, cmd in runs.items()}
    got = {}
    try:
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=WORLD_TIMEOUT)
            assert proc.returncode == 0, f"{k}:\n{stderr[-4000:]}"
            got[k] = stdout if k == "cli" else json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    cell = out_dir / "phi3-mini-3.8b__train_4k__h100x32x8.json"
    got["cli"] = json.loads(cell.read_text())
    return got


@pytest.mark.parametrize("arch", MINI_LM)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_mini_dry_run_counts_work_and_collectives(mini, arch, kind):
    got = mini[arch][kind]
    assert got["flops"] > 0 and got["bytes"] > 0
    assert got["collective_bytes"] > 0
    assert sum(got["by_link"].values()) == got["collective_bytes"]
    assert got["peak_bytes"] >= got["params_bytes"] + got["optimizer_bytes"] + got["cache_bytes"]
    assert (got["optimizer_bytes"] > 0) == (kind == "train")
    assert (got["cache_bytes"] > 0) == (kind == "decode")


@pytest.mark.parametrize("arch,kind", [("deepseek-v3-671b", "prefill"), ("xlstm-350m", "train"),
                                       ("xlstm-350m", "prefill")])
def test_mini_dry_run_traces_the_repaired_cells(mini, arch, kind):
    """deepseek's MLA prefill writes its placed caches; xlstm's sLSTM runs
    on each rank's rows.  A prefill's cache per rank is at most the global
    cache over the batch shards: each rank built its own block only."""
    got = mini[arch][kind]
    assert got["flops"] > 0 and got["bytes"] > 0 and got["collective_bytes"] > 0
    assert got["peak_bytes"] >= got["params_bytes"] + got["optimizer_bytes"] + got["cache_bytes"]
    if kind == "prefill":
        assert 0 < got["cache_bytes"] <= mini[arch]["global_cache_bytes"] / BATCH_SHARDS


@pytest.mark.parametrize("arch", ["qwen2-72b", "llama4-scout-17b-a16e", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_mini_train_holds_no_global_logits(mini, arch):
    """The loss runs on each rank's vocabulary shard: no storage of the
    step is as large as the batch's float32 logits."""
    got = mini[arch]["train"]
    assert 0 < got["largest_bytes"] < mini[arch]["global_logits_bytes"]


def test_mini_deepseek_train_holds_only_its_own_slots_and_one_blocks_scores(mini):
    """deepseek-v3's train step: the MoE makes no (T*k, D) tensor of every
    token-expert assignment on a rank (its buffer's slots only), and no
    attention scores are live at the peak, which falls after the backward:
    each block's live only while its own backward runs (under a mesh the
    dense prefix and the MTP head are recomputed too; else they hold theirs
    through the whole step, one at this peak)."""
    got = mini["deepseek-peak"]
    assert got["scores_made"] > 0
    assert got["assignments_made"] == 0
    assert got["scores_at_peak"] == 0


def test_mini_dry_run_of_the_fusion_workload(mini):
    for variant in ("baseline", "analytic"):
        got = mini["paper-bayes-fusion"][variant]
        assert got["bytes"] > 0 and got["collective_bytes"] == 0
    assert mini["paper-bayes-fusion"]["baseline"]["bytes"] > \
        mini["paper-bayes-fusion"]["analytic"]["bytes"]


def test_main_refuses_a_started_process_group(mini):
    assert "already started" in mini["paper-bayes-fusion"]["refused"]


def test_cli_cell_has_the_reference_keys(mini):
    got = mini["cli"]
    # the reference's result (``_result`` over ``Roofline.to_dict``), two keys renamed
    ref_keys = {"variant", "ok", "calibrated", "compile_seconds", "memory_analysis",
                "collective_counts_schedule", "arch", "shape", "mesh", "chips",
                "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
                "collective_by_kind", "model_flops_total", "compute_s", "memory_s",
                "collective_s", "bottleneck", "useful_ratio", "peak_memory_bytes"}
    assert set(got) == ref_keys - {"compile_seconds", "memory_analysis"} \
        | {"trace_seconds", "memory", "collective_by_link"}
    assert got["ok"] is True and got["calibrated"] is True
    assert (got["mesh"], got["chips"]) == ("h100x32x8", 256)
    assert got["flops_per_chip"] > 0 and got["collective_by_link"]["ib"] > 0
    assert set(got["memory"]) == {"params_gb", "optimizer_gb", "cache_gb", "peak_gb"}
