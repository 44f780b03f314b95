"""Training loop: microbatched grad accumulation, AdamW, fault hooks.

``make_train_step`` builds the eager step: ``api.loss``, its backward (each
repetition of the block stack recomputed under ``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``), then ``adamw.apply`` in place;
``TrainLoop`` drives data, checkpointing, preemption, straggler watch and
loss-spike rewind.  ``TrainLoop(mesh=...)`` keeps the mesh, as the
reference's does, and runs the same single-device step: the reference's
``run`` jits its step without shardings.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.distributed import fault
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # grad-accumulation factor
    ckpt_every: int = 50
    ckpt_dir: str | None = None      # None: a new directory under the TMPDIR


def _grads(params, cfg, batch):
    """(loss, {name: grad}) of one batch; a parameter the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    named = dict(params.named_parameters())
    loss, _ = api.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {name: torch.zeros_like(p) if g is None else g
                           for (name, p), g in zip(named.items(), grads)}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` (the model) and ``opt_state`` are updated in place and
    returned.  With microbatches, the batch is split as the reference splits
    it (``(mb, B / mb, ...)``), the gradients are summed in float32 from zeros
    and divided by ``mb``, and so are the losses -- and the new params take
    the float32 of those gradients, as the reference's do.
    """

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        if microbatches > 1:
            dev = next(iter(named.values())).device
            gsum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: x.reshape((microbatches, x.shape[0] // microbatches) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss, grads = _grads(params, cfg, mb)
                for n, g in grads.items():
                    gsum[n].add_(g)
                lsum = lsum + loss
                del grads
            n_mb = torch.tensor(float(microbatches), dtype=torch.float32, device=dev)
            grads = {n: g.div_(n_mb) for n, g in gsum.items()}
            loss = lsum / n_mb
        else:
            loss, grads = _grads(params, cfg, batch)
            grads = {n: g.contiguous() for n, g in grads.items()}
        new_params, opt_state, om = adamw.apply(grads, opt_state, opt_cfg)
        with torch.no_grad():
            for n, p in named.items():
                p.data = new_params[n]        # the gradient's buffer, now the new param
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


class TrainLoop:
    """Single-device driver with the full fault-tolerance surface."""

    def __init__(
        self,
        model_cfg,
        data_cfg: DataConfig,
        train_cfg: TrainConfig,
        opt_cfg: adamw.AdamWConfig | None = None,
        mesh=None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.train_cfg = train_cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=train_cfg.steps)
        self.mesh = mesh
        # a fixed default would let two runs resume from each other's state
        self.ckpt = Checkpointer(train_cfg.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_"))
        self.guard = fault.PreemptionGuard(install=False)
        self.straggler = fault.StragglerWatch()
        self.spike = fault.SpikeRewind()
        self.history: list[Dict[str, float]] = []

    def init_state(self, key):
        params = api.init(self.model_cfg, key, device=self.device)
        opt_state = adamw.init(params)
        return params, opt_state

    def run(self, key, start_step: int = 0, params=None, opt_state=None):
        if params is None:
            params, opt_state = self.init_state(key)
        step_fn = make_train_step(self.model_cfg, self.opt_cfg, self.train_cfg.microbatches)
        step = start_step
        # resume from the latest committed checkpoint if present (restored in
        # place, as the rewind below restores into the live state)
        latest = self.ckpt.latest_step()
        if latest is not None and latest > start_step:
            latest, (params, opt_state) = self.ckpt.restore((params, opt_state), latest)
            step = latest

        while step < self.train_cfg.steps:
            self.straggler.step_start()
            batch = batch_at_step(self.data_cfg, step, device=self.device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            self.straggler.step_end(step)
            self.history.append({"step": step, "loss": loss})

            if self.spike.observe(loss):
                # divergence: rewind to last committed checkpoint
                latest = self.ckpt.latest_step()
                if latest is not None:
                    latest, (params, opt_state) = self.ckpt.restore((params, opt_state))
                    step = latest
                    continue
            step += 1
            if step % self.train_cfg.ckpt_every == 0 or self.guard.requested:
                self.ckpt.save(step, (params, opt_state))
            if self.guard.requested:
                self.ckpt.wait()
                break
        self.ckpt.wait()
        return params, opt_state, self.history
