"""Dry run of an H100 cluster: per (arch x shape x mesh) roofline terms of one
rank's step, with nothing allocated and nothing compiled.

    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k \\
        --mesh single --device cpu

The reference lowers and compiles each cell for a 512-device TPU host and
reads XLA's cost analysis.  Here one process plays rank 0 of a fake world of
256 GPUs (``--mesh single``, ``h100x32x8``; ``multi``, ``h100x2x16x8``): ``torch.distributed``'s ``fake`` backend (its collectives move nothing)
under ``FakeTensorMode`` (its tensors hold no memory).  The rank builds the
params with ``api.init``, places them by ``sharding.param_shardings`` as
DTensors, and runs its train, prefill or decode step eagerly -- the port's
own code, DTensor's redistributions included -- while
``roofline.StepCounter`` counts its local FLOPs, bytes, collectives and live
storage.  ``--device`` names the fake tensors' device (``cuda``, the
default, or ``cpu``); the counts do not depend on the machine, but DTensor
on a ``cpu`` mesh swaps an all-to-all for an all-gather and a chunk.

Each cell is written to ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's keys, two renamed: ``trace_seconds`` (for ``compile_seconds``)
and ``memory`` (for ``memory_analysis``: per rank, the params, optimizer
state and decode cache, and the peak of live storage, in GB).  A cell that
fails is written ``ok: false`` with its error; nothing is retried.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.train.loop import make_train_step

LM_ARCHS = (
    "qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b",
    "internvl2-26b", "recurrentgemma-2b", "xlstm-350m",
    "llama4-scout-17b-a16e", "deepseek-v3-671b", "seamless-m4t-large-v2",
)

# long_500k needs sub-quadratic state; skips per DESIGN.md SS4
LONG_OK = {"recurrentgemma-2b", "xlstm-350m", "llama4-scout-17b-a16e"}

N_PATCH = 256  # internvl2 stub patch embeddings


def cell_is_runnable(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_OK and arch != "paper-bayes-fusion":
        return False, "pure full-attention arch: 512k-token cache skip (DESIGN.md SS4)"
    return True, ""


# ----------------------------------------------------------------- input specs

class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def input_specs(arch: str, shape: ShapeConfig, cfg) -> dict:
    """Shape and dtype of every model input (nothing allocated).  The fusion
    workload's entropy words are int32 bit patterns, the width of the
    reference's uint32."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f32 = torch.float32
    if arch == "paper-bayes-fusion":
        pixels = cfg.frames_per_batch * cfg.height * cfg.width
        return {
            "p_modal": TensorSpec((cfg.modalities, pixels, cfg.classes), f32),
            "rand": TensorSpec((cfg.modalities, pixels, cfg.classes, cfg.n_bits // 4), i32),
        }
    if shape.kind in ("train", "prefill"):
        out = {"tokens": TensorSpec((b, _text_len(cfg, s)), i32)}
        if shape.kind == "train":
            out["labels"] = TensorSpec((b, _text_len(cfg, s)), i32)
        extra = _extra_len(cfg, s)
        if extra:
            out["extra_embeds"] = TensorSpec((b, extra, cfg.d_model), f32)
        return out
    # decode: one new token against a cache of length s
    return {"token": TensorSpec((b,), i32), "pos": TensorSpec((), i32)}


def _text_len(cfg, s: int) -> int:
    return s - N_PATCH if cfg.family == "vlm" else s


def _extra_len(cfg, s: int) -> int:
    if cfg.family == "vlm":
        return N_PATCH
    if cfg.family == "audio":
        return s // cfg.enc_ratio
    return 0


# --------------------------------------------------------------- step builders

def make_train_fn(cfg, microbatches: int = 1):
    """The port's train step (``train.loop.make_train_step``: ``api.loss``,
    autograd with each repetition recomputed, ``adamw.apply`` in place a
    slice at a time), returning the reference's ``(params, opt_state,
    grad_norm, loss)``."""
    step = make_train_step(cfg, adamw.AdamWConfig(), microbatches)

    def train_step(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics["grad_norm"], metrics["loss"]

    return train_step


def make_bayes_fn(cfg, path: str = "both", rng_inside: bool = False):
    """Movie-S1-scale fusion step on the port's plain versions of the kernels
    (``sne_encode_ref``, ``pand_popcount_ref``, ``fusion_map_ref``), composed
    as the reference composes its ``*_ref``.

    path:      "both" (stochastic circuit + analytic oracle), "stochastic",
               or "analytic" (the production recommendation -- SSPerf finding).
    rng_inside: draw the entropy words inside the step (``prng.device_bits``)
               instead of streaming pre-drawn words from memory.
    ``rand`` holds int32 bit patterns; the plain versions take int64 words.
    """
    from repro_torch.kernels.fusion_map.ref import fusion_map_ref
    from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref
    from repro_torch.kernels.sne_encode.ref import sne_encode_ref

    def prior_of(p):
        k = p.shape[-1]
        return torch.full((k,), 1.0 / k, dtype=torch.float32, device=p.device)

    def fused(stoch):
        return torch.argmax(stoch, -1), torch.amax(stoch, -1)

    if path == "analytic":
        def bayes_step(p_modal):
            analytic = fusion_map_ref(p_modal, prior_of(p_modal))
            return fused(analytic) + (analytic,)

        return bayes_step

    def stochastic(p_modal, rand):
        m = p_modal.shape[0]
        words = rand.to(torch.int64) & 0xFFFFFFFF
        streams = sne_encode_ref(p_modal, words)         # (M, pixels, K, W)
        counts = pand_popcount_ref(
            streams.reshape(m, -1, streams.shape[-1])
        ).reshape(p_modal.shape[1:])                     # (pixels, K)
        cf = counts.to(torch.float32)
        stoch = cf / torch.clamp(cf.sum(-1, keepdim=True), min=1.0)
        if path == "both":
            return fused(stoch) + (fusion_map_ref(p_modal, prior_of(p_modal)),)
        return fused(stoch) + (stoch,)

    if rng_inside:
        def bayes_step(p_modal):
            rand = prng.device_bits(prng.PRNGKey(0), tuple(p_modal.shape) + (cfg.n_bits // 4,),
                                    device=p_modal.device)
            return stochastic(p_modal, rand)

        return bayes_step

    return stochastic


# ---------------------------------------------------------------- model flops

def model_flops(cfg, shape: ShapeConfig, params) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (2*N*D forward-only), MoE uses N_active.
    ``params`` is a port model (or a dict of tensors by state-dict key); a
    key's dotted parts stand for the reference's pytree path."""
    named = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    total = expert = embed = 0.0
    for key, leaf in named:
        n = float(math.prod(leaf.shape))
        keys = key.split(".")
        total += n
        if "moe" in keys and any(k in ("wi", "wg", "wo") for k in keys):
            expert += n
        if keys[-1] == "embed":
            embed += n
    if cfg.moe is not None:
        active = total - expert + expert * cfg.moe.top_k / cfg.moe.num_experts
    else:
        active = total
    n_eff = active - embed  # embedding gather is not a matmul
    if shape.kind == "train":
        return 6.0 * n_eff * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_eff * shape.global_batch * shape.seq_len
    tokens = shape.global_batch
    attn = 0.0
    if cfg.family != "ssm":
        hd = cfg.resolved_head_dim
        attn = 4.0 * shape.global_batch * shape.seq_len * cfg.num_heads * hd * cfg.num_layers
    return 2.0 * n_eff * tokens + attn


# -------------------------------------------------------------------- building

def _batch_spec(mesh, ndim: int) -> tuple:
    """Placements of a batch input: dim 0 over the batch axes."""
    bax = sharding.batch_axes(mesh)
    return sharding.placements(((bax if len(bax) > 1 else bax[0]),) + (None,) * (ndim - 1), mesh)


def _batch_div(mesh) -> int:
    sizes = sharding.mesh_sizes(mesh)
    return math.prod(sizes[a] for a in sharding.batch_axes(mesh))


def _init_state_abstract(cfg, batch: int, t_cache: int, *, device="cuda"):
    """The empty decode state of ``batch`` rows and ``t_cache`` slots: per
    decoder block its cache (the enc-dec's also its cross k/v of
    ``t_cache / enc_ratio`` frames)."""
    from repro_torch.models import layers as L

    if cfg.family == "audio":
        hd = cfg.resolved_head_dim
        enc_len = t_cache // cfg.enc_ratio
        kv = (batch, enc_len, cfg.num_kv_heads, hd)
        return {
            "self": [L.init_kv_cache(batch, t_cache, cfg.num_kv_heads, hd, device=device)
                     for _ in range(cfg.dec_layers)],
            "cross": [{"k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                       "v": torch.zeros(kv, dtype=torch.bfloat16, device=device)}
                      for _ in range(cfg.dec_layers)],
        }
    return transformer.init_decode_state(cfg, batch, t_cache, device=device)


def _on(tree, dev):
    """``tree`` (a model, or dicts and lists of tensors) built on ``meta``,
    with every tensor replaced by an empty one of its shape on ``dev``."""
    if isinstance(tree, torch.nn.Module):
        for mod in tree.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                mod.register_parameter(name, torch.nn.Parameter(
                    torch.empty_like(p, device=dev), requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    return tree if tree is None else torch.empty_like(tree, device=dev)


def build_step(cfg, shape: ShapeConfig, mesh, arch: str, microbatches: int = 1, *,
               device="cuda"):
    """The cell's step function and its arguments (train/prefill/decode),
    placed on ``mesh`` (``None``: one device).  Called under a
    ``FakeTensorMode`` it allocates nothing.  The params and the decode
    state are built on ``meta`` (``api.init``'s shapes, no draws) and then
    given empty tensors on ``device``: a count does not read values."""
    dev = torch.device(device)
    specs = input_specs(arch, shape, cfg)
    params = _on(api.init(cfg, prng.PRNGKey(0), device="meta"), dev)
    if mesh is not None:
        sharding.distribute_params(params, mesh)
    if shape.kind in ("train", "prefill"):
        batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev) for k, s in specs.items()}
        if mesh is not None:
            batch = {k: sharding.shard(v, mesh, _batch_spec(mesh, v.dim()))
                     for k, v in batch.items()}
        if shape.kind == "train":
            return make_train_fn(cfg, microbatches), (params, adamw.init(params), batch)
        return _inference(lambda p, b: api.prefill(p, cfg, b, shape.seq_len)), (params, batch)
    state = _init_state_abstract(cfg, shape.global_batch, shape.seq_len, device="meta")
    token = torch.zeros(specs["token"].shape, dtype=torch.int32, device=dev)
    if mesh is None:
        state = _on(state, dev)
    else:
        state = sharding.place_state(state, mesh, device=dev)
        batched = shape.global_batch % _batch_div(mesh) == 0
        token = sharding.shard(token, mesh, _batch_spec(mesh, 1) if batched
                               else sharding.placements((None,), mesh))
    pos = shape.seq_len - 1           # the last slot: every cache slot is attended
    return _inference(lambda p, t, s: api.decode(p, cfg, t, s, pos)), (params, token, state)


def _inference(fn):
    """``fn`` without autograd, as the serving engine runs its model calls."""
    def step(*args):
        with torch.no_grad():
            return fn(*args)

    return step


def count_step(step, args, mesh=None, counter=None) -> rf.StepCounter:
    """Run ``step(*args)`` once under ``counter`` (a new
    :class:`roofline.StepCounter` by default) and the mesh's context; the
    arguments' storages count as live from the start.  The step's result is
    kept as the counter's ``result``."""
    counter = rf.StepCounter(mesh) if counter is None else counter
    ctx = dctx.mesh_context(mesh) if mesh is not None else contextlib.nullcontext()
    with counter, ctx:
        counter.track([list(a.parameters()) if isinstance(a, torch.nn.Module) else a
                       for a in args])
        counter.result = step(*args)
    return counter


def _local_bytes(tree) -> int:
    """Bytes of this rank's storage of every tensor in ``tree`` (a model, or
    dicts, lists and named tuples of tensors)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    leaves = tree_flatten(list(tree.parameters()) if isinstance(tree, torch.nn.Module)
                          else tree)[0]
    return sum((t.to_local() if isinstance(t, DTensor) else t).untyped_storage().nbytes()
               for t in leaves if isinstance(t, torch.Tensor))


def _measure(cfg, shape, mesh, arch, microbatches: int = 1, *, device="cuda") -> dict:
    """Per-rank counts of one traced step (``roofline.counts_of``) and the
    bytes of its params, optimizer state and decode cache (the cache a
    decode step is given, or the one a prefill returns)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_step(cfg, shape, mesh, arch, microbatches, device=device)
        counter = count_step(step, args, mesh)
        cache = {"decode": args[-1], "prefill": counter.result[-1]}.get(shape.kind)
        sizes = {"params_bytes": _local_bytes(args[0]),
                 "optimizer_bytes": _local_bytes(args[1]) if shape.kind == "train" else 0,
                 "cache_bytes": _local_bytes(cache)}
        return {**rf.counts_of(counter), **sizes}


def reduced_cfg(cfg, r: int):
    """Full-width, depth-r-repetitions, unrolled config for cost calibration."""
    big = 1 << 30
    if cfg.family == "audio":
        return dataclasses.replace(
            cfg, enc_layers=r, dec_layers=r, num_layers=2 * r,
            unroll_layers=True, q_chunk=big, mlstm_chunk=big,
        )
    n = len(cfg.prefix_kinds) + r * len(cfg.pattern)
    return dataclasses.replace(
        cfg, num_layers=n, unroll_layers=True, q_chunk=big, mlstm_chunk=big,
    )


def _reps(cfg) -> int:
    if cfg.family == "audio":
        return cfg.enc_layers  # enc and dec scale together in the reduced cfg
    return (cfg.num_layers - len(cfg.prefix_kinds)) // len(cfg.pattern)


def _extrapolate(f1, f2, reps):
    """``fixed + body * reps`` of each count, where ``body = f2 - f1``."""
    if isinstance(f1, dict):
        return {k: _extrapolate(f1.get(k, 0), f2.get(k, 0), reps) for k in set(f1) | set(f2)}
    return f1 + (f2 - f1) * (reps - 1)


def calibrate(cfg, shape, mesh, arch, microbatches: int = 1, *, device="cuda") -> dict:
    """Per-rank counts at full depth from traces of 1 and 2 repetitions.

    The reference calibrates because XLA's cost analysis counts a loop body
    once.  The port's eager count is exact at any depth, but a DTensor trace
    of a deep model is slow, and every count here is linear in the
    repetitions: ``total = fixed + body * reps``.  The depth is cut as
    :func:`reduced_cfg` cuts it; the chunk sizes stay the config's, so the
    count (and the peak) is the production step's.
    """
    def at(r):
        c = dataclasses.replace(reduced_cfg(cfg, r), q_chunk=cfg.q_chunk,
                                mlstm_chunk=cfg.mlstm_chunk)
        return _measure(c, shape, mesh, arch, microbatches, device=device)

    return _extrapolate(at(1), at(2), _reps(cfg))


def _mesh_name(multi_pod: bool) -> str:
    return PRODUCTION_MESHES[multi_pod][0]


def _bayes_cell(cfg, opts, shape, mesh, arch, *, device="cuda") -> dict:
    """The fusion step on this rank's pixels (the reference's ``P(None,
    all_axes, None)``): every op is per pixel, so the rank runs the plain
    composition on its own slice and issues no collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    specs = input_specs(arch, shape, cfg)
    every = tuple(mesh.mesh_dim_names)
    fn = make_bayes_fn(cfg, path=opts["bayes_path"], rng_inside=opts["rng_inside"])
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = {k: sharding.shard(torch.zeros(s.shape, dtype=s.dtype, device=device), mesh,
                                   sharding.placements((None, every) + (None,) * (len(s.shape) - 2),
                                                       mesh)).to_local()
                 for k, s in specs.items()}
        args = (local["p_modal"],) if opts["rng_inside"] or opts["bayes_path"] == "analytic" \
            else (local["p_modal"], local["rand"])
        return {**rf.counts_of(count_step(fn, args)),
                "params_bytes": 0, "optimizer_bytes": 0, "cache_bytes": 0}


def run_cell(arch: str, shape_name: str, multi_pod: bool, variant: str = "baseline", *,
             device="cuda") -> dict:
    """Count one (arch x shape x mesh) cell on the started world; returns
    its result dict."""
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    mesh_name = _mesh_name(multi_pod)
    chips = mesh.size()
    t0 = time.time()
    cfg, opts = apply_variant(get_config(arch), variant)
    if arch == "paper-bayes-fusion":
        shape = SHAPES_BY_NAME.get(shape_name, SHAPES_BY_NAME["train_4k"])
        counts = _bayes_cell(cfg, opts, shape, mesh, arch, device=device)
        pixels = cfg.frames_per_batch * cfg.height * cfg.width
        mflops = 10.0 * pixels * cfg.classes * cfg.modalities
        calibrated = False
    else:
        shape = SHAPES_BY_NAME[shape_name]
        mflops = model_flops(cfg, shape, api.init(cfg, prng.PRNGKey(0), device="meta"))
        calibrated = _reps(cfg) > 2
        counts = (calibrate if calibrated else _measure)(
            cfg, shape, mesh, arch, opts["microbatches"], device=device)
    roof = rf.from_counts(arch, shape_name, mesh_name, chips, counts, mflops)
    return {
        "variant": variant,
        "ok": True,
        "calibrated": calibrated,
        "trace_seconds": round(time.time() - t0, 1),
        "memory": {k.replace("_bytes", "_gb"): counts[k] / 1e9
                   for k in ("params_bytes", "optimizer_bytes", "cache_bytes", "peak_bytes")},
        "collective_counts_schedule": counts["counts"],
        **roof.to_dict(),
    }


def apply_variant(cfg, variant: str):
    """Named config variants for the SSPerf hillclimb.

    Returns (cfg, opts) where opts carries non-config knobs (microbatches,
    fsdp2d sharding policy, paper-bayes path selection).
    """
    opts = {"microbatches": 1, "bayes_path": "both", "rng_inside": False}
    sharding.POLICY["fsdp2d"] = False
    if variant == "baseline":
        return cfg, opts
    changes = {}
    for part in variant.split("+"):
        if part == "nosp":
            changes["seq_shard"] = False
        elif part.startswith("qchunk"):
            changes["q_chunk"] = int(part[len("qchunk"):])
        elif part.startswith("mchunk"):
            changes["mlstm_chunk"] = int(part[len("mchunk"):])
        elif part == "moedense":
            changes["moe"] = dataclasses.replace(cfg.moe, impl="dense")
        elif part == "fsdp2d":
            sharding.POLICY["fsdp2d"] = True
        elif part.startswith("micro"):
            opts["microbatches"] = int(part[len("micro"):])
        elif part in ("analytic", "stochastic"):
            opts["bayes_path"] = part
        elif part.startswith("bits"):
            changes["n_bits"] = int(part[len("bits"):])
        elif part == "rnginside":
            opts["rng_inside"] = True
        else:
            raise ValueError(f"unknown variant component {part!r}")
    return dataclasses.replace(cfg, **changes), opts


# ------------------------------------------------------------------------ main

@contextlib.contextmanager
def fake_world(size: int):
    """Rank 0 of a fake process group of ``size`` ranks, for the ``with`` block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", help="the fake tensors' device: cuda or cpu")
    args = ap.parse_args(argv)

    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise RuntimeError("a process group is already started; the dry run starts its own "
                           "fake world, one per mesh, in a process of its own")
    archs = list(LM_ARCHS) + ["paper-bayes-fusion"] if args.arch == "all" else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for multi in meshes:
        mesh_name = _mesh_name(multi)
        with fake_world(math.prod(PRODUCTION_MESHES[multi][1])):
            for arch in archs:
                for shape_name in shapes:
                    if arch == "paper-bayes-fusion" and shape_name != "train_4k":
                        continue  # one canonical cell for the paper workload
                    runnable, why = cell_is_runnable(arch, shape_name)
                    tag = f"{arch}__{shape_name}__{mesh_name}"
                    if args.variant != "baseline":
                        tag += f"__{args.variant}"
                    path = os.path.join(args.out, tag + ".json")
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            if json.load(f).get("ok", False):
                                print(f"[skip existing] {tag}")
                                continue
                    if not runnable:
                        with open(path, "w") as f:
                            json.dump({"ok": False, "skipped": True, "reason": why,
                                       "arch": arch, "shape": shape_name,
                                       "mesh": mesh_name}, f, indent=1)
                        print(f"[skipped] {tag}: {why}")
                        continue
                    try:
                        res = run_cell(arch, shape_name, multi, args.variant, device=args.device)
                        with open(path, "w") as f:
                            json.dump(res, f, indent=1, default=str)
                        print(
                            f"[ok] {tag}: trace={res['trace_seconds']}s "
                            f"flops/chip={res['flops_per_chip']:.3e} "
                            f"coll={res['collective_bytes_per_chip']:.3e}B "
                            f"bottleneck={res['bottleneck']} "
                            f"peak={res['memory']['peak_gb']:.1f}GB",
                            flush=True,
                        )
                    except Exception as e:  # noqa: BLE001 -- a failed cell is recorded, the grid goes on
                        failures += 1
                        with open(path, "w") as f:
                            json.dump({"ok": False, "error": str(e),
                                       "trace": traceback.format_exc()[-4000:],
                                       "arch": arch, "shape": shape_name,
                                       "mesh": mesh_name}, f, indent=1)
                        print(f"[FAIL] {tag}: {str(e)[:300]}", flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
