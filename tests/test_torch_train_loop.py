"""The port's training step and loop (``repro_torch.train``) and the train
launcher against the live reference, on the CPU.

Tolerances:

* gradients with float32 weights on both sides, all ten archs' smoke
  configs: each leaf within GRAD_LEAF_REL of that leaf's largest value
  (measured at most 1.5e-5: float32 sums in other orders), against
  ``jax.jit(jax.value_and_grad(api.loss))``; the loss within F32_LOSS_RTOL;
  seamless's first encoder norm within one bf16 ulp (SEAMLESS_BF16_LEAVES);
* bf16 losses within LOSS_ATOL of the compiled reference's (PRs 21-22's
  bound; XLA keeps bf16 intermediates in float32), the MoE archs only where
  no token's experts differ (their routing is compared in
  ``test_torch_lm_models.py``);
* one ``make_train_step`` against the reference's compiled step, bf16: the
  loss within LOSS_ATOL, the grad norm within NORM_RTOL.  The first AdamW
  step moves each weight by about ``lr`` times the sign of its gradient, so
  a bf16 gradient that rounds to another sign (near zero) moves it the other
  way: the new params within one bf16 ulp but for at most STEP_FLIP_SHARE of
  them, and all within 2 lr (+ 1 ulp);
* microbatches: 4 against 1 on the port as the reference's own test holds
  them (loss rtol 1e-3, params atol 2e-2), and the float32 promotion: after
  a microbatched step the params are float32 on both sides;
* a loop resumed from a checkpoint, or rewound by a loss spike, ends bit for
  bit where the uninterrupted loop ends (one thread, the same device);
* the ``train_lm`` example against the reference script's loop: every
  step's loss within LOSS_TRAJ_ATOL.
"""

import dataclasses
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.configs import get_smoke_config as jsmoke
from repro.data import pipeline as jpipeline
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import train as launch
from repro_torch.models import api, convert
from repro_torch.optim import AdamWConfig, adamw, compression
from repro_torch.train import TrainConfig, TrainLoop, make_train_step

torch.set_num_threads(1)

ARCHS = [a for a in R.ARCH_IDS if a != "paper-bayes-fusion"]
GRAD_LEAF_REL = 1e-4
F32_LOSS_RTOL = 1e-5
LOSS_ATOL = 5e-3
NORM_RTOL = 2e-2
STEP_FLIP_SHARE = 1e-2
LOSS_TRAJ_ATOL = 2e-2
BF16_ULP = 2.0 ** -7
# seamless's encoder reads its frames in bf16 in both packages, so its first
# norm's output is bf16 and feeds three float32 matmuls: the reference
# promotes it at each and sums three cotangents rounded to bf16, the port
# promotes it once and rounds the float32 sum.  These leaves are held within
# one bf16 ulp of their largest value (measured 4.2e-3 compiled, 5.9e-3 op
# by op); every other seamless leaf within GRAD_LEAF_REL
SEAMLESS_BF16_LEAVES = ("['enc_blocks']['norm1']['bias']", "['enc_blocks']['norm1']['scale']")


def _ref_params(arch, dtype=None):
    ref = jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(0)))
    return ref if dtype is None else jax.tree.map(lambda x: x.astype(dtype), ref)


def _batch(cfg, batch=2, seq=16, seed=1):
    """tests/models/test_smoke_archs.py's make_batch: (reference's, port's)."""
    kt, ke = jax.random.split(jax.random.PRNGKey(seed))
    tokens = jax.random.randint(kt, (batch, seq), 0, cfg.vocab_size)
    out = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    if cfg.frontend == "patch":
        out["extra_embeds"] = jax.random.normal(ke, (batch, 4, cfg.d_model), jnp.float32)
    elif cfg.frontend == "frame":
        out["extra_embeds"] = jax.random.normal(ke, (batch, seq // cfg.enc_ratio, cfg.d_model))
    return out, {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _ref_flat(tree):
    return {jtu.keystr(p): np.asarray(leaf, np.float32)
            for p, leaf in jtu.tree_flatten_with_path(tree)[0]}


def _port_flat(named):
    out = {}
    for key, members in convert.reference_leaves(dict(named)):
        arrs = [named[n].detach().float().numpy() for _, n in members]
        out[key] = np.stack(arrs) if members[0][0] is not None else arrs[0]
    return out


class _Routes:
    """Records the expert ids of every MoE router call: in the compiled
    reference through a debug callback, in the port directly."""

    def __enter__(self):
        from repro.models import moe as jmoe
        from repro_torch.models import moe

        self.mods, self.ref, self.port = (jmoe, moe), [], []
        self._j, self._t = jmoe._router_probs, moe._router_probs

        def jrec(logits, kind, k):
            out = self._j(logits, kind, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)), out[1], ordered=True)
            return out

        def trec(logits, kind, k):
            out = self._t(logits, kind, k)
            self.port.append(out[1].numpy().copy())
            return out
        jmoe._router_probs, moe._router_probs = jrec, trec
        return self

    def __exit__(self, *exc):
        self.mods[0]._router_probs, self.mods[1]._router_probs = self._j, self._t

    def agree(self):
        jax.effects_barrier()
        return len(self.ref) == len(self.port) and all(
            np.array_equal(a, b) for a, b in zip(self.ref, self.port))


# ------------------------------------------------------------------ gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_float32_gradients_match_the_compiled_reference(arch):
    ref = _ref_params(arch, np.float32)
    model = convert.params_from_reference(ref, device="cpu")
    jcfg = jsmoke(arch)
    if jcfg.family == "audio":
        # the reference's encoder casts its frames to bf16, and its layer scan
        # then refuses a float32 carry; unrolled, the same ops run
        jcfg = dataclasses.replace(jcfg, unroll_layers=True)
    jb, pb = _batch(jcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb), has_aux=True))(jax.tree.map(jnp.asarray, ref))
    loss, _ = api.loss(model, get_smoke_config(arch), pb)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
    assert all(g is not None for g in grads), arch          # every leaf has a gradient
    assert loss.item() == pytest.approx(float(jl), rel=F32_LOSS_RTOL)
    want, got = _ref_flat(jg), _port_flat(dict(zip(names, grads)))
    assert list(got) == list(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        bound = BF16_ULP if k in SEAMLESS_BF16_LEAVES and jcfg.family == "audio" else GRAD_LEAF_REL
        assert float(np.abs(got[k] - want[k]).max()) <= bound * scale, (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_on_the_training_path(arch):
    """The gradient half of tests/models/test_smoke_archs.py's
    test_train_step_smoke: with grad enabled (each repetition checkpointed)
    the loss is the plain forward's, every leaf gets a finite gradient; the
    loss within LOSS_ATOL of the compiled reference's where every token
    routes alike."""
    ref = _ref_params(arch)
    cfg = get_smoke_config(arch)
    model = convert.params_from_reference(ref, cfg, device="cpu")
    jb, pb = _batch(jsmoke(arch))
    with _Routes() as routes:
        jl = float(jax.jit(lambda p, b: japi.loss(p, jsmoke(arch), b)[0])(
            jax.tree.map(jnp.asarray, ref), jb))
        with torch.no_grad():
            plain, _ = api.loss(model, cfg, pb)
        same_routes = routes.agree()
    loss, _ = api.loss(model, cfg, pb)
    assert loss.requires_grad and loss.item() == plain.item()
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g.float()).all()) for g in grads), arch
    assert all(g.dtype == p.dtype for g, p in zip(grads, params))
    assert 1.0 < loss.item() < 3.0 * np.log(cfg.vocab_size)
    if same_routes:
        assert abs(loss.item() - jl) <= LOSS_ATOL, (loss.item(), jl)


# ------------------------------------------------------------------ one step
def _one_step(arch, microbatches, opt=AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    ref = _ref_params(arch)
    data = DataConfig(seed=1, global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
    jparams = jax.tree.map(jnp.asarray, ref)
    jstep = jax.jit(jloop.make_train_step(jcfg, jadamw.AdamWConfig(**vars(opt)), microbatches))
    jp, jo, jm = jstep(jparams, jadamw.init(jparams),
                       jpipeline.batch_at_step(jpipeline.DataConfig(**vars(data)), 0))
    model = convert.params_from_reference(ref, cfg, device="cpu")
    pp, po, pm = make_train_step(cfg, opt, microbatches)(
        model, adamw.init(model), batch_at_step(data, 0, device="cpu"))
    return (jp, jo, jm), (pp, po, pm), opt


@pytest.mark.parametrize("arch,microbatches", [("qwen2-72b", 1), ("qwen2-72b", 2),
                                               ("phi3-mini-3.8b", 1)])
def test_train_step_matches_the_reference(arch, microbatches):
    (jp, jo, jm), (pp, po, pm), opt = _one_step(arch, microbatches)
    assert abs(pm["loss"].item() - float(jm["loss"])) <= LOSS_ATOL
    assert pm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=NORM_RTOL)
    assert pm["lr"].item() == pytest.approx(float(jm["lr"]), rel=2.0 ** -23)   # XLA's cos
    assert int(po.step) == int(jo.step) == 1
    want, got = _ref_flat(jp), _port_flat(dict(pp.named_parameters()))
    dtypes = {jtu.keystr(p): str(x.dtype) for p, x in jtu.tree_flatten_with_path(jp)[0]}
    flips = total = 0
    for k in want:
        named = dict(pp.named_parameters())
        member = convert.reference_leaves(named)
        assert {str(named[n].dtype)[6:] for kk, ms in member if kk == k for _, n in ms} \
            == {dtypes[k]}, k                  # the params' dtypes: the reference's
        diff = np.abs(got[k] - want[k])
        ulp = BF16_ULP * np.abs(want[k]) + 1e-30
        flips += int(np.sum(diff > ulp))
        total += diff.size
        assert float(diff.max()) <= 2 * opt.lr * 1.01 + float(ulp.max()), k
    assert flips <= STEP_FLIP_SHARE * total, (flips, total)


def test_microbatch_equivalence():
    """tests/train/test_train_loop.py's test, on the port: 4 microbatches
    against one batch; then the float32 promotion of a microbatched step."""
    cfg = get_smoke_config("qwen2-72b")
    data = DataConfig(seed=1, global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)
    batch = batch_at_step(data, 0, device="cpu")
    out = {}
    for mb in (1, 4):
        params = api.init(cfg, prng.PRNGKey(0), device="cpu")
        out[mb] = make_train_step(cfg, opt, microbatches=mb)(params, adamw.init(params), batch)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    np.testing.assert_allclose(m1["loss"].item(), m4["loss"].item(), rtol=1e-3)
    for (n, a), (_, b) in zip(p1.named_parameters(), p4.named_parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   atol=2e-2, err_msg=n)
    assert {p.dtype for p in p4.parameters()} == {torch.float32}
    assert {p.dtype for p in p1.parameters()} == {torch.bfloat16, torch.float32}


def test_seamless_trains_on_after_a_microbatched_step():
    """After a microbatched step every param is float32 (the reference's
    promotion); seamless's encoder then takes its bf16 frames up to float32
    at the first matmul, as the reference's unrolled encoder does."""
    cfg = get_smoke_config("seamless-m4t-large-v2")
    data = DataConfig(seed=1, global_batch=4, seq_len=16, vocab_size=cfg.vocab_size,
                      frontend="frame", n_extra=16 // cfg.enc_ratio, d_model=cfg.d_model)
    params = api.init(cfg, prng.PRNGKey(0), device="cpu")
    state = adamw.init(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=4), 2)
    losses = []
    for s in range(2):
        params, state, m = step(params, state, batch_at_step(data, s, device="cpu"))
        losses.append(m["loss"].item())
    assert {p.dtype for p in params.parameters()} == {torch.float32}
    assert all(np.isfinite(losses))


# ---------------------------------------------------------------------- loop
def _small_setup(tmp_path, steps=12, arch="qwen2-72b"):
    cfg = get_smoke_config(arch)
    data_cfg = DataConfig(seed=1, global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    train_cfg = TrainConfig(steps=steps, ckpt_every=5, ckpt_dir=str(tmp_path / "ckpt"),
                            microbatches=1)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    return cfg, data_cfg, train_cfg, opt_cfg


def test_loss_decreases(tmp_path):
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path, steps=15)
    loop = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cpu")
    _, _, history = loop.run(prng.PRNGKey(0))
    first = np.mean([h["loss"] for h in history[:3]])
    last = np.mean([h["loss"] for h in history[-3:]])
    assert last < first - 0.2, f"loss did not decrease: {first} -> {last}"
    assert [h["step"] for h in history] == list(range(15))
    assert loop.ckpt.available_steps() == [5, 10, 15]


def test_checkpoint_restart_resumes(tmp_path):
    """Stop at step 5, restart -> identical final state as the uninterrupted run."""
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path, steps=10)
    p_full, o_full, _ = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cpu").run(
        prng.PRNGKey(0))
    cfg2, data2, tc2, oc2 = _small_setup(tmp_path / "b", steps=10)
    TrainLoop(cfg2, data2, dataclasses.replace(tc2, steps=5), oc2, device="cpu").run(
        prng.PRNGKey(0))
    loop_b = TrainLoop(cfg2, data2, tc2, oc2, device="cpu")
    p_res, o_res, hist = loop_b.run(prng.PRNGKey(0))
    assert [h["step"] for h in hist] == [5, 6, 7, 8, 9]
    for (n, a), (_, b) in zip(p_full.named_parameters(), p_res.named_parameters()):
        assert torch.equal(a, b), n
    for k in o_full.m:
        assert torch.equal(o_full.m[k], o_res.m[k]) and torch.equal(o_full.master[k],
                                                                     o_res.master[k])


def test_spike_rewind_restores_the_last_checkpoint(tmp_path):
    """A loss spike rewinds to the last committed checkpoint and replays the
    same batches: the loop ends where the undisturbed loop ends."""
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path, steps=8)
    train_cfg = dataclasses.replace(train_cfg, ckpt_every=3)
    p_ref, _, _ = TrainLoop(cfg, data_cfg, dataclasses.replace(
        train_cfg, ckpt_dir=str(tmp_path / "ref")), opt_cfg, device="cpu").run(prng.PRNGKey(0))
    loop = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cpu")
    seen = []
    observe = loop.spike.observe

    def spiky(loss):
        seen.append(loss)
        return observe(loss) or len(seen) == 5     # the 5th step "diverges"
    loop.spike.observe = spiky
    p, _, hist = loop.run(prng.PRNGKey(0))
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert hist[3]["loss"] == hist[5]["loss"] and hist[4]["loss"] == hist[6]["loss"]
    for (n, a), (_, b) in zip(p_ref.named_parameters(), p.named_parameters()):
        assert torch.equal(a, b), n


def test_compressed_grads_converge():
    """tests/train/test_compressed_training.py's test, on the port."""
    cfg = get_smoke_config("qwen2-72b")
    data_cfg = DataConfig(seed=3, global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)

    def run(compressed: bool):
        params = api.init(cfg, prng.PRNGKey(0), device="cpu")
        opt = adamw.init(params)
        named = dict(params.named_parameters())
        residual = {n: torch.zeros(p.shape, dtype=torch.float32) for n, p in named.items()}
        losses = []
        for step in range(20):
            loss, _ = api.loss(params, cfg, batch_at_step(data_cfg, step, device="cpu"))
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
            if compressed:
                q, s, residual = compression.compress(
                    prng.fold_in(prng.PRNGKey(9), step), grads, residual)
                grads = compression.decompress(q, s)
            new, opt, _ = adamw.apply(grads, opt, opt_cfg)
            with torch.no_grad():
                for n, p in named.items():
                    p.data = new[n]
            losses.append(loss.item())
        return losses

    base = run(False)
    comp = run(True)
    assert base[-1] < base[0] - 0.3
    assert comp[-1] < comp[0] - 0.3
    assert abs(comp[-1] - base[-1]) < 0.35, (base[-1], comp[-1])


def test_train_loop_refuses_a_mesh_and_a_missing_card(tmp_path):
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainLoop(cfg, data_cfg, train_cfg, opt_cfg)


def test_default_checkpoint_directory_is_new_for_each_loop(tmp_path, monkeypatch):
    """Without a ``ckpt_dir`` (or ``--ckpt-dir``) each loop checkpoints into a
    new directory under the TMPDIR, so no run resumes from another's state."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert TrainConfig().ckpt_dir is None and launch.setup([])[3].ckpt_dir is None
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path, steps=2)
    train_cfg = dataclasses.replace(train_cfg, ckpt_dir=None, ckpt_every=1)
    loops = [TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cpu") for _ in range(2)]
    hists = [loop.run(prng.PRNGKey(0))[2] for loop in loops]
    dirs = [loop.ckpt.directory for loop in loops]
    assert dirs[0] != dirs[1] and all(os.path.dirname(d) == str(tmp_path) for d in dirs)
    assert [[h["step"] for h in hist] for hist in hists] == [[0, 1], [0, 1]]
    assert [loop.ckpt.available_steps() for loop in loops] == [[1, 2], [1, 2]]


# ------------------------------------------------------------------ launcher
def test_launch_train_smoke_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --smoke --device cpu`` against the
    reference's launcher: the same summary line, the losses within tolerance
    of each other (the reference's steps run compiled)."""
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "6"]
    history = launch.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    port_line = capsys.readouterr().out.strip().splitlines()[0]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + ["--ckpt-dir", str(tmp_path / "ref")])
    jlaunch.main()
    ref_line = capsys.readouterr().out.strip().splitlines()[0]
    fields = [dict(f.split("=") for f in line.split()) for line in (port_line, ref_line)]
    assert fields[0]["arch"] == fields[1]["arch"] == "phi3-smoke"
    assert fields[0]["steps"] == fields[1]["steps"] == "6" and len(history) == 6
    for k in ("first_loss", "last_loss"):
        assert abs(float(fields[0][k]) - float(fields[1][k])) <= 0.02, (k, fields)
    # ckpt_every = steps // 4 = 1: the last three steps' checkpoints are kept
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["step_4", "step_5", "step_6"]


# ------------------------------- tests/train/test_fault_ckpt.py's fault tests
def test_straggler_watch():
    from repro_torch.distributed import fault

    watch = fault.StragglerWatch(threshold=3.0)
    for step in range(10):
        assert not watch.observe(step, 0.1)
    assert watch.observe(10, 1.0)          # 10x slower -> flagged
    assert watch.flagged_steps == [10]
    assert not watch.observe(11, 0.1)      # recovery


def test_spike_rewind():
    from repro_torch.distributed import fault

    guard = fault.SpikeRewind(factor=3.0, patience=2)
    assert not guard.observe(2.0)
    assert not guard.observe(2.1)
    assert not guard.observe(9.0)          # first spike: patience
    assert guard.observe(9.5)              # second consecutive -> rewind
    assert not guard.observe(2.0)          # reset after rewind


def test_preemption_guard_stops_the_loop_with_a_checkpoint(tmp_path):
    """The guard's flag (test_preemption_guard_flag) ends a run after the
    step it is raised in, with a checkpoint of that step."""
    cfg, data_cfg, train_cfg, opt_cfg = _small_setup(tmp_path, steps=10)
    loop = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cpu")
    assert not loop.guard.requested
    observe = loop.spike.observe

    def preempt_at_step_2(loss):
        if len(loop.history) == 3:
            loop.guard._handler(None, None)
        return observe(loss)
    loop.spike.observe = preempt_at_step_2
    _, _, hist = loop.run(prng.PRNGKey(0))
    assert loop.guard.requested and [h["step"] for h in hist] == [0, 1, 2]
    assert loop.ckpt.available_steps() == [3]


# ------------------------------------------------------------------- example
EXAMPLE_SIZES = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
                     d_ff=128, vocab_size=512)


def test_train_lm_example_against_the_reference_loop(tmp_path):
    """``examples.train_lm.run`` at reduced sizes against the reference
    script's loop (its data, optimizer and checkpoint cadence) at the same
    sizes: the losses within LOSS_TRAJ_ATOL per step (bf16 trajectories
    part by ulps each step), the same checkpoints, the loss falling."""
    from repro_torch.examples import train_lm

    got = train_lm.run("cpu", steps=8, **EXAMPLE_SIZES)
    jcfg = dataclasses.replace(jsmoke("qwen2-72b"), name="qwen2-30m", **EXAMPLE_SIZES)
    loop = jloop.TrainLoop(
        jcfg, jpipeline.DataConfig(seed=0, global_batch=8, seq_len=128, vocab_size=512),
        jloop.TrainConfig(steps=8, ckpt_every=2, ckpt_dir=str(tmp_path)),
        jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8))
    _, _, hist = loop.run(jax.random.PRNGKey(0))
    want = [h["loss"] for h in hist]
    assert got["steps"] == 8 and len(got["losses"]) == 8
    assert max(abs(a - b) for a, b in zip(got["losses"], want)) <= LOSS_TRAJ_ATOL
    assert got["checkpoints"] == loop.ckpt.available_steps() == [4, 6, 8]
    assert got["losses"][-1] < got["losses"][0]
    assert got["n_params"] == sum(x.size for x in jax.tree.leaves(
        japi.init(jcfg, jax.random.PRNGKey(0))))


def test_train_lm_example_prints_what_the_script_prints(capsys):
    from repro_torch.examples import train_lm

    train_lm.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "training qwen2-30m: 8.1M params, 2 steps, batch 8 x seq 128"
    assert out[1].startswith("loss: ") and out[2] == "checkpoints committed at: [1, 2]"
