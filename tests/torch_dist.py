"""Run a world of gloo ranks for a test, and the worlds the tests run.

``run_world(world, n, tmp_path, **kw)`` starts a subprocess that spawns ``n``
ranks (``torch.multiprocessing.spawn``).  Each rank sets one thread, joins a
gloo process group through a file under ``tmp_path`` (parallel test workers
never share a port), calls the world function ``world`` of this module as
``world(rank, n, **kw)`` and writes the dict of arrays it returns to
``rank<r>.npz``.  The whole world runs under a timeout, in a session of its
own that is killed if the timeout passes, so a hung collective fails its test
instead of holding the suite; each rank's group also times out on its own.
``run_world`` returns the ranks' dicts in rank order.

The world functions import torch, numpy and ``repro_torch`` only; the tests
hold their results against the JAX reference in the test process.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 360          # seconds for a whole spawned world
GROUP_TIMEOUT = 150          # seconds a rank waits in a collective


def run_world(world: str, n: int, tmp_path, timeout: float = WORLD_TIMEOUT, **kw) -> list:
    """Run ``world`` on ``n`` gloo ranks; returns each rank's result dict."""
    tmp = pathlib.Path(tmp_path)
    args = tmp / f"{world}.npz"
    np.savez(args, **{k: np.asarray(v) for k, v in kw.items()})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    proc = subprocess.Popen([sys.executable, __file__, world, str(n), str(tmp)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"world {world} on {n} ranks passed its {timeout} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"world {world} on {n} ranks failed ({proc.returncode}):\n"
                             f"{out[-6000:]}")
    return [dict(np.load(tmp / f"{world}.rank{r}.npz")) for r in range(n)]


def _rank_main(rank: int, n: int, world: str, tmp: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{world}.init", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        kw = {k: v for k, v in np.load(f"{tmp}/{world}.npz").items()}
        res = globals()[world](rank, n, **kw)
        np.savez(f"{tmp}/{world}.rank{rank}.npz", **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# --------------------------------------------------------------------------- worlds

def sweep(rank, n, key, n_bits, mesh_shape, mesh_names, names, **ev):
    """``compile_network`` sharded over the world, per scenario of ``names``
    (evidence ``ev[name]``): ``devices=n`` and ``devices=None`` under
    ``mesh_context`` of a mesh of ``mesh_shape`` (sharding over its batch
    axes), run and decide beside the unsharded network; a batch the shards do
    not divide; a recalibrated sharded network; and shards whose frame
    origins wrap the 2**32 counters, gathered as the sharded launch gathers."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.bayesnet import NoiseModel, by_name, compile_network, recalibrated_network
    from repro_torch.bayesnet import compile as C
    from repro_torch.distributed import context as dctx
    from repro_torch.kernels.net_sweep import net_sweep

    n_bits = int(n_bits)
    mesh = init_device_mesh("cpu", tuple(int(s) for s in mesh_shape),
                            mesh_dim_names=tuple(str(a) for a in mesh_names))
    out = {}
    for name in (str(x) for x in names):
        spec, frames = by_name(name), ev[name]
        single = compile_network(spec, n_bits=n_bits, device="cpu")
        shard = compile_network(spec, n_bits=n_bits, devices=n, device="cpu")
        with dctx.mesh_context(mesh):
            ambient = compile_network(spec, n_bits=n_bits, device="cpu")
        out[f"{name}.shards"] = np.array([shard.n_shards, ambient.n_shards])
        out[f"{name}.axes"] = np.array(["/".join(shard.shard_axes), "/".join(ambient.shard_axes)])
        for tag, net in (("single", single), ("devices", shard), ("ambient", ambient)):
            p, a = net.run(key, frames)
            pd, d, ad = net.decide(key, frames)
            out.update({f"{name}.{tag}.post": _np(p), f"{name}.{tag}.acc": _np(a),
                        f"{name}.{tag}.dpost": _np(pd), f"{name}.{tag}.dec": _np(d),
                        f"{name}.{tag}.dacc": _np(ad)})
        p_odd, a_odd = shard.run(key, frames[:frames.shape[0] - 3])
        out[f"{name}.odd.post"], out[f"{name}.odd.acc"] = _np(p_odd), _np(a_odd)
    spec = by_name("intersection")
    noisy = compile_network(spec, n_bits=n_bits, devices=n, noise=NoiseModel.nominal(),
                            device="cpu")
    recal = recalibrated_network(noisy, 3.0)
    out["recal.shards"] = np.int32(recal.n_shards)
    out["recal.post"] = _np(recal.run(key, ev["intersection"])[0])
    # shards of a batch whose node offsets and frame counters wrap 2**32
    frames = torch.from_numpy(ev["intersection"])
    b = frames.shape[0]
    per, f0, total = b // n, 2**25 - 7, 2**25 + 9
    net = compile_network(spec, n_bits=n_bits, devices=n, device="cpu")
    idx = C._shard_index(net.mesh, net.shard_axes, net.mesh.get_coordinate())
    part = net_sweep(key, frames[idx * per:(idx + 1) * per], plan=net.plan, n_bits=n_bits,
                     frame0=f0 + idx * per, total_frames=total, decide=True)
    whole = C._gather_frames(net.mesh, net.shard_axes,
                             torch.cat([t.reshape(per, -1) for t in part], 1), b)
    want = net_sweep(key, frames, plan=net.plan, n_bits=n_bits, frame0=f0, total_frames=total,
                     decide=True)
    out["wrap.got"] = _np(whole)
    out["wrap.want"] = _np(torch.cat([t.reshape(b, -1) for t in want], 1))
    # the example, at a small size; frame_mesh over the world and past it
    from repro_torch.examples import sharded_sweep

    r = sharded_sweep.run("cpu", frames=64, n_bits=128, reps=1, max_batch=16)
    out["example"] = np.array([r["identical"], r["drained"], r["n_shards"], r["devices"]])
    out["frame_mesh.names"] = np.array(dctx.frame_mesh(device="cpu").mesh_dim_names)
    try:
        dctx.frame_mesh(n + 1, device="cpu")
    except ValueError as e:
        out["frame_mesh.err"] = np.array(str(e))
    return out


def _mesh(shape, names, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(int(x) for x in shape),
                            mesh_dim_names=tuple(str(a) for a in names))


def _tree(flat: dict, prefix: str) -> dict:
    """``{"a.b": array}`` entries under ``prefix`` -> a nested dict of tensors."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.asarray(v))
    return out


def models(rank, n, moe_x, lm_tokens, grad, **flat):
    """On a (2, 2) ("data", "model") world: the MoE layer local and expert
    parallel; the smoke qwen2's loss unsharded and with params placed by
    ``param_shardings`` under the mesh (recording each ``constrain`` call);
    ``compressed_mean`` over ``data`` of this rank's gradient shard;
    ``constrain``'s fallbacks; and the smoke qwen2's gradients (float32
    weights) sharded and unsharded, then ``adamw.apply`` on DTensors and on
    plain tensors fed the same gradients."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.models import api, moe
    from repro_torch.optim import compression

    mesh = _mesh((2, 2), ("data", "model"))
    out = {"coord": np.array(mesh.get_coordinate())}

    # --- MoE: expert parallel over `model` == the local path ---------------
    mcfg = get_smoke_config("llama4-scout-17b-a16e")
    mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, num_experts=8,
                                                             capacity_factor=8.0))
    mp = _tree(flat, "moe.")
    x = torch.from_numpy(moe_x)
    with torch.no_grad():
        logits = x.reshape(-1, x.shape[-1]) @ mp["router"]
        out["moe.ids"] = _np(moe._router_probs(logits, mcfg.moe.router, mcfg.moe.top_k)[1])
        out["moe.local"], out["moe.aux_local"] = map(_np, moe.moe_apply(mp, x, mcfg))
        with dctx.mesh_context(mesh):
            out["moe.ep"], out["moe.aux_ep"] = map(_np, moe.moe_apply(mp, x, mcfg))

    # --- the sharded loss ----------------------------------------------------
    cfg = get_smoke_config("qwen2-72b")
    cfg = dataclasses.replace(cfg, d_model=64, num_heads=4, num_kv_heads=4)
    params = api.init(cfg, prng.PRNGKey(0), device="cpu")
    tokens = torch.from_numpy(lm_tokens)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        out["lm.plain"] = _np(api.loss(params, cfg, batch)[0])
    sharding.distribute_params(params, mesh)
    placed = {k: [str(p) for p in v.placements] for k, v in params.named_parameters()}
    want = sharding.param_shardings(params, mesh)
    assert all(placed[k] == [str(p) for p in want[k]] for k in placed), placed
    bs = {k: sharding.shard(v, mesh, sharding.batch_sharding(mesh)) for k, v in batch.items()}
    calls = []
    plain_constrain = dctx.constrain

    def recording(x, *spec):
        y = plain_constrain(x, *spec)
        calls.append((spec, tuple(x.shape),
                      tuple(str(p) for p in y.placements) if isinstance(y, DTensor) else ()))
        return y

    dctx.constrain = recording
    try:
        with torch.no_grad(), dctx.mesh_context(mesh):
            loss, metrics = api.loss(params, cfg, bs)
    finally:
        dctx.constrain = plain_constrain
    out["lm.sharded"] = _np(loss)
    out["lm.constrain"] = np.array([f"{s}|{sh}|{pl}" for s, sh, pl in calls])

    # --- the sharded loss of an MoE model: its layers take the EP path ------
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    params = api.init(cfg, prng.PRNGKey(0), device="cpu")
    tokens = torch.from_numpy(lm_tokens % cfg.vocab_size)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        loss, metrics = api.loss(params, cfg, batch)
        out["moe_lm.plain"], out["moe_lm.plain_nll"] = _np(loss), _np(metrics["nll"])
        sharding.distribute_params(params, mesh)
        bs = {k: sharding.shard(v, mesh, sharding.batch_sharding(mesh)) for k, v in batch.items()}
        with dctx.mesh_context(mesh):
            loss, metrics = api.loss(params, cfg, bs)
        out["moe_lm.sharded"], out["moe_lm.sharded_nll"] = _np(loss), _np(metrics["nll"])

    # --- compressed_mean over `data` ------------------------------------------
    d = mesh.get_local_rank("data")
    g = torch.from_numpy(grad)
    rows = g.shape[0] // 2
    shard = {"w": g[d * rows:(d + 1) * rows]}
    mean, res = compression.compressed_mean(prng.PRNGKey(0), shard,
                                            {"w": torch.zeros_like(shard["w"])}, "data", mesh)
    out["cm.mean"], out["cm.res"] = _np(mean["w"]), _np(res["w"])

    # --- constrain's fallbacks --------------------------------------------------
    y = torch.arange(8 * 3 * 4, dtype=torch.float32).reshape(8, 3, 4)
    yd = DTensor.from_local(y, mesh, [Replicate(), Replicate()], run_check=False)
    cases = {"batch_vocab": ("batch", None, "model"), "unknown_axis": ("pod", None, "model"),
             "indivisible": (None, "model", None), "used_twice": ("data", "data", "model"),
             "tuple": (("data", "model"), None, None), "replicate": (None, None, None)}
    with dctx.mesh_context(mesh):
        for tag, spec in cases.items():
            z = dctx.constrain(yd, *spec)
            out[f"c.{tag}"] = np.array([str(p) for p in z.placements])
            assert torch.equal(z.full_tensor(), y), tag
        assert dctx.constrain(y, "batch", None, "model") is y        # a plain tensor
    assert dctx.constrain(yd, "batch", None, "model") is yd          # no mesh

    # --- a sharded train step: the gradients, then AdamW on each rank's shards
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), d_model=64, num_heads=4,
                              num_kv_heads=4)
    tokens = torch.from_numpy(lm_tokens)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def float32(model):
        # float32 weights: the shards' partial sums in bf16 would part the two
        # backwards by bf16 roundings, not by a fault
        for mod in model.modules():
            for name, w in list(mod.named_parameters(recurse=False)):
                mod.register_parameter(name, torch.nn.Parameter(w.detach().float()))
        return model

    plain = float32(api.init(cfg, prng.PRNGKey(0), device="cpu"))
    placed = sharding.distribute_params(float32(api.init(cfg, prng.PRNGKey(0), device="cpu")),
                                        mesh)
    bs = {k: sharding.shard(v, mesh, sharding.batch_sharding(mesh)) for k, v in batch.items()}
    loss_p, grads_p = loop._grads(plain, cfg, batch)
    with dctx.mesh_context(mesh):
        loss_s, grads_s = loop._grads(placed, cfg, bs)
        loss_t = api.loss(placed, cfg, bs)[0]
    # the backward on a thread of its own, as a CUDA backward runs on
    # autograd's device thread: the caller's thread-local state (implicit
    # replication on) but not its context variables (no ambient mesh)
    import threading

    named = dict(placed.named_parameters())
    box = {}

    def backward():
        DTensor._op_dispatcher._allow_implicit_replication = True
        box["g"] = torch.autograd.grad(loss_t, list(named.values()))

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(GROUP_TIMEOUT)
    out["step.thread_equal"] = np.array(all(
        torch.equal(g.full_tensor(), grads_s[k].full_tensor())
        for k, g in zip(named, box["g"])))
    out["step.loss"] = np.array([_np(loss_p), _np(loss_s)])
    out["step.grad_err"] = np.array(max(
        float((grads_s[k].full_tensor() - g).abs().max() / g.abs().max())
        for k, g in grads_p.items() if g.abs().max() > 0))
    # the same gradients (scaled under the clip) through both updates
    place = sharding.param_shardings(placed, mesh)
    small = {k: g * 1e-3 for k, g in grads_p.items()}
    cfg_o = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    new_p, opt_p, m_p = adamw.apply({k: g.clone() for k, g in small.items()},
                                    adamw.init(plain), cfg_o)
    with dctx.mesh_context(mesh):
        new_s, opt_s, m_s = adamw.apply(
            {k: sharding.shard(g.clone(), mesh, place[k]) for k, g in small.items()},
            adamw.init(placed), cfg_o)
    out["adamw.gnorm"] = np.array([_np(m_p["grad_norm"]), _np(m_s["grad_norm"])])
    out["adamw.placements"] = np.array(sorted({str(tuple(new_s[k].placements)) for k in new_s}))
    out["adamw.equal"] = np.array([
        all(torch.equal(a[k], b[k].full_tensor()) for k in a)
        for a, b in ((new_p, new_s), (opt_p.master, opt_s.master), (opt_p.m, opt_s.m),
                     (opt_p.v, opt_s.v))])
    return out


def lm(rank, n, lm_tokens, attn_q, attn_kv, slstm_x, rglru_x, rglru_conv, logits, labels):
    """On a (2, 2, 2) ("pod", "data", "model") world, whose batch is split
    over two axes: ``context.vocab_nll`` and its gradient beside
    ``log_softmax`` on the same logits; ``multihead_attention`` with the
    heads split over `model` (KV heads that divide it and KV heads that do
    not) beside the unsharded call; the sLSTM and the RG-LRU on each rank's
    rows, in a sequence and in a decode step, beside the unsharded ones (and
    the RG-LRU's parameter gradients, and the storage of its state); the smoke
    qwen2's loss and gradients (float32 weights) sharded and unsharded, and
    the largest storage the sharded step holds; prefill and a decode step,
    sharded and unsharded, of the smoke qwen2, starcoder2 (one KV head),
    deepseek-v3 (no MoE), xlstm and recurrentgemma (float32 weights), with
    the caches' placements beside ``sharding.place_state``'s and the largest
    storage under each state leaf beside the leaf's block."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models import api, layers, transformer, xlstm
    from repro_torch.train import loop

    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    out = {"coord": np.array(mesh.get_coordinate())}
    rows = sharding.batch_sharding(mesh)
    rep = [Replicate()] * 3

    def placed(t, spec):
        return sharding.shard(t, mesh, sharding.placements(spec, mesh))

    # --- the vocab-sharded NLL on logits split (batch over pod, data; vocab over model)
    x = torch.from_numpy(logits).requires_grad_(True)
    lab = torch.from_numpy(labels)
    nll = -torch.gather(torch.log_softmax(x, -1), -1, lab[..., None].long())[..., 0]
    out["nll.plain"] = _np(nll)
    out["nll.plain_grad"] = _np(torch.autograd.grad(nll.mean(), x)[0])
    xd = placed(x.detach(), (("pod", "data"), None, "model")).requires_grad_(True)
    with dctx.mesh_context(mesh):
        nd = transformer._nll(xd, placed(lab, (("pod", "data"), None)))
        out["nll.sharded"] = _np(nd)
        out["nll.placements"] = np.array([str(p) for p in nd.placements])
        out["nll.sharded_grad"] = _np(torch.autograd.grad(nd.mean(), xd)[0])

    # --- attention with the heads split over `model` ---------------------------
    q = torch.from_numpy(attn_q)
    pos = torch.arange(q.shape[1])
    for kvh in (2, 3, 1):    # KV heads that `model` divides, and two counts it does not
        k, v = (torch.from_numpy(attn_kv[i, :, :, :kvh]) for i in (0, 1))
        kw = dict(kind="causal", q_positions=pos, k_positions=pos, q_chunk=4)
        out[f"attn{kvh}.plain"] = _np(layers.multihead_attention(q, k, v, **kw))
        with dctx.mesh_context(mesh):
            got = layers.multihead_attention(*(placed(t, (("pod", "data"), None, None, None))
                                               for t in (q, k, v)), **kw)
        out[f"attn{kvh}.sharded"] = _np(got)
        out[f"attn{kvh}.placements"] = np.array([str(p) for p in got.placements])
        out[f"attn{kvh}.local_heads"] = np.int32(got.to_local().shape[2])

    # --- the sLSTM on each rank's rows ---------------------------------------
    cfg = dataclasses.replace(get_smoke_config("xlstm-350m"), d_model=slstm_x.shape[-1])
    sp = {k: (v.float() if torch.is_tensor(v) else {kk: vv.float() for kk, vv in v.items()})
          for k, v in xlstm.slstm_init(prng.PRNGKey(3), cfg, device="cpu").items()}
    xs = torch.from_numpy(slstm_x)
    with torch.no_grad():
        # the plain sLSTM on each batch shard's rows (a matmul's rounding
        # depends on its row count), the shards' results concatenated
        part = xs.shape[0] // 4
        runs = [xlstm.slstm_apply(sp, xs[i:i + part], cfg) for i in range(0, xs.shape[0], part)]
        steps = [xlstm.slstm_apply(sp, xs[i:i + part, :1], cfg, st)
                 for i, (_, st) in zip(range(0, xs.shape[0], part), runs)]
        y, y1 = (torch.cat([o for o, _ in rr]) for rr in (runs, steps))
        st, st1 = ({k: torch.cat([s_[k] for _, s_ in rr]) for k in "cnmh"} for rr in (runs, steps))
        with dctx.mesh_context(mesh):
            xd = placed(xs, (("pod", "data"), None, None))
            yd, sd = xlstm.slstm_apply(sp, xd, cfg)
            y1d, sd1 = xlstm.slstm_apply(sp, xd[:, :1], cfg, sd)
    for tag, a, b in (("seq", (y, st), (yd, sd)), ("step", (y1, st1), (y1d, sd1))):
        out[f"slstm.{tag}.plain"] = np.stack([_np(a[0])[:, -1]] + [_np(a[1][k]) for k in "cnmh"])
        out[f"slstm.{tag}.sharded"] = np.stack([_np(b[0])[:, -1]]
                                               + [_np(b[1][k]) for k in "cnmh"])

    # --- the RG-LRU on each rank's rows (float32 weights) ------------------------
    from repro_torch.models import rglru

    # inputs, conv taps and dense weights on coarse dyadic grids, so that
    # every matmul before the scan is exact in float32 whatever its order or
    # shape: the scan on a rank's rows gets the plain scan's inputs bit for bit
    cfg = get_smoke_config("recurrentgemma-2b")
    rp = {k: torch.round(v.float() * 16) / 16 if v.dim() == 2 else v
          for k, v in rglru.rglru_init(prng.PRNGKey(4), cfg, device="cpu").items()}
    rp["conv"] = torch.from_numpy(rglru_conv)
    xs = torch.from_numpy(rglru_x)
    part = xs.shape[0] // 4
    with torch.no_grad():
        runs = [rglru.rglru_apply(rp, xs[i:i + part], cfg) for i in range(0, xs.shape[0], part)]
        steps = [rglru.rglru_apply(rp, xs[i:i + part, :1], cfg, st)
                 for i, (_, st) in zip(range(0, xs.shape[0], part), runs)]
    rd = {k: sharding.shard(v, mesh, sharding.placements(sharding.spec_for_leaf((k,), v.shape,
                                                                                mesh), mesh))
          for k, v in rp.items()}
    with torch.no_grad(), dctx.mesh_context(mesh):
        xd = placed(xs, (("pod", "data"), None, None))
        yd, sd = rglru.rglru_apply(rd, xd, cfg)
        y1d, sd1 = rglru.rglru_apply(rd, xd[:, :1], cfg, sd)
    for tag, rr, (yy, ss) in (("seq", runs, (yd, sd)), ("step", steps, (y1d, sd1))):
        out[f"rglru.{tag}.out"] = np.stack([_np(torch.cat([o for o, _ in rr])), _np(yy)])
        for k in ("conv", "h"):
            out[f"rglru.{tag}.{k}"] = np.stack([_np(torch.cat([st[k] for _, st in rr])),
                                                _np(ss[k])])
            local = ss[k].to_local()
            out[f"rglru.{tag}.{k}.storage"] = np.array(
                [local.untyped_storage().nbytes(), local.numel() * local.element_size()])
    # its gradients: the parameters used on each rank's rows summed over them
    wgt = torch.from_numpy(rglru_x[::-1].copy())
    plain = {k: v.clone().requires_grad_(True) for k, v in rp.items()}
    y, _ = rglru.rglru_apply(plain, xs, cfg)
    grads_p = torch.autograd.grad((y * wgt).sum(), list(plain.values()))
    leaves = {k: v.detach().requires_grad_(True) for k, v in rd.items()}
    with dctx.mesh_context(mesh):
        y, _ = rglru.rglru_apply(leaves, placed(xs, (("pod", "data"), None, None)), cfg)
        grads_s = torch.autograd.grad((y * placed(wgt, (("pod", "data"), None, None))).sum(),
                                      list(leaves.values()))
    out["rglru.grad_err"] = np.array(max(
        float((s_.full_tensor() - g).abs().max() / g.abs().max())
        for g, s_ in zip(grads_p, grads_s)))

    # --- the sharded loss and its gradients (float32 weights) ------------------
    def float32(model):
        for mod in model.modules():
            for name, w in list(mod.named_parameters(recurse=False)):
                mod.register_parameter(name, torch.nn.Parameter(w.detach().float()))
        return model

    cfg = get_smoke_config("qwen2-72b")
    tokens = torch.from_numpy(lm_tokens)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        out["loss.bf16_plain"] = _np(api.loss(api.init(cfg, prng.PRNGKey(0), device="cpu"), cfg,
                                              batch)[0])
        bf16 = sharding.distribute_params(api.init(cfg, prng.PRNGKey(0), device="cpu"), mesh)
        with dctx.mesh_context(mesh):
            out["loss.bf16_sharded"] = _np(api.loss(bf16, cfg, {
                k: sharding.shard(v, mesh, rows) for k, v in batch.items()})[0])
    plain = float32(api.init(cfg, prng.PRNGKey(0), device="cpu"))
    sharded = sharding.distribute_params(float32(api.init(cfg, prng.PRNGKey(0), device="cpu")),
                                         mesh)
    loss_p, grads_p = loop._grads(plain, cfg, batch)
    counter = StepCounter(mesh)
    with counter, dctx.mesh_context(mesh):
        loss_s, grads_s = loop._grads(sharded, cfg, {k: sharding.shard(v, mesh, rows)
                                                     for k, v in batch.items()})
    out["loss.f32"] = np.array([_np(loss_p), _np(loss_s)])
    out["loss.grad_err"] = np.array(max(
        float((grads_s[k].full_tensor() - g).abs().max() / g.abs().max())
        for k, g in grads_p.items() if g.abs().max() > 0))
    out["loss.largest_bytes"] = np.int64(counter.largest_bytes)
    out["loss.all_reduces"] = np.int64(sum(r.kind == "all-reduce" and r.axis == "model"
                                           for r in counter.records))

    # --- prefill and decode, sharded and unsharded -----------------------------
    for arch in ("qwen2-72b", "starcoder2-15b", "deepseek-v3-671b", "xlstm-350m",
                 "recurrentgemma-2b"):
        cfg = get_smoke_config(arch)
        if arch == "starcoder2-15b":
            # one KV head, which `model` does not divide: its cache splits the sequence
            cfg = dataclasses.replace(cfg, num_kv_heads=1)
        toks = torch.from_numpy(lm_tokens[:, :12] % cfg.vocab_size)
        if arch == "deepseek-v3-671b":
            # MLA without MoE: routing flips at bf16 near-ties, and the EP path
            # keeps its capacity per batch shard (test_torch_dist_models holds it)
            cfg = dataclasses.replace(cfg, moe=None)
        params = api.init(cfg, prng.PRNGKey(1), device="cpu")
        if arch in ("xlstm-350m", "recurrentgemma-2b"):
            # float32 weights: the recurrences amplify the sharded matmuls'
            # bf16 roundings
            params = float32(params)
        with torch.no_grad():
            logits_p, state_p = api.prefill(params, cfg, {"tokens": toks}, 16)
            step_p, _ = api.decode(params, cfg, toks[:, -1], state_p, 12)
            sharding.distribute_params(params, mesh)
            with dctx.mesh_context(mesh):
                logits_s, state_s = api.prefill(
                    params, cfg, {"tokens": sharding.shard(toks, mesh, rows)}, 16)
                step_s, _ = api.decode(params, cfg, sharding.shard(toks[:, -1], mesh,
                                                                   sharding.placements(
                                                                       (("pod", "data"),), mesh)),
                                       state_s, 12)
        want = sharding.place_state(transformer.init_decode_state(cfg, 8, 16, device="meta"),
                                    mesh, device="cpu")
        flat_s, flat_w, flat_p = (torch.utils._pytree.tree_flatten(t)[0]
                                  for t in (state_s, want, state_p))
        out[f"{arch}.logits"] = np.stack([_np(logits_p), _np(logits_s)])
        out[f"{arch}.step"] = np.stack([_np(step_p), _np(step_s)])
        # per leaf: its largest error, its largest value, whether it is bf16
        out[f"{arch}.cache_err"] = np.array([
            [np.abs(_np(a) - _np(b)).max(), np.abs(_np(a)).max(), a.dtype == torch.bfloat16]
            for a, b in zip(flat_p, flat_s)], dtype=np.float64)
        # per leaf: its block's bytes, and the bytes of the storage under it
        out[f"{arch}.state_storage"] = np.array([
            [a.to_local().numel() * a.element_size(), a.to_local().untyped_storage().nbytes()]
            for a in flat_s], dtype=np.int64)
        out[f"{arch}.cache_placed"] = np.array([
            isinstance(a, DTensor) and tuple(a.placements) == tuple(b.placements)
            and a.to_local().shape == b.to_local().shape for a, b in zip(flat_s, flat_w)])
    return out


def pipeline(rank, n, x, w1, w2):
    """GPipe on a (4, 2) ("pod", "data") world: the reference test's residual
    MLP stages over `pod` (4 stages) and over `data` (the first 2 stages), at
    1, 3 and all microbatches of ``x``; and the unpipelined oracle."""
    from repro_torch.distributed.pipeline import pipeline_forward, reference_forward
    from repro_torch.models import layers

    mesh = _mesh((4, 2), ("pod", "data"))

    def stage_fn(p, h):
        return h + layers.gelu(h @ p["w1"]) @ p["w2"]

    out = {"coord": np.array(mesh.get_coordinate())}
    with torch.no_grad():
        for axis, stages in (("pod", 4), ("data", 2)):
            params = {"w1": torch.from_numpy(w1[:stages]), "w2": torch.from_numpy(w2[:stages])}
            for m in (1, 3, x.shape[0]):
                xt = torch.from_numpy(x[:m])
                out[f"{axis}.{m}.pipe"] = _np(pipeline_forward(stage_fn, params, xt, mesh,
                                                               axis=axis))
                out[f"{axis}.{m}.ref"] = _np(reference_forward(stage_fn, params, xt))
    return out


if __name__ == "__main__":
    import torch.multiprocessing as mp

    world_name, n_ranks, tmp_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank_main, args=(n_ranks, world_name, tmp_dir), nprocs=n_ranks)
