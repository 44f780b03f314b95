"""End-to-end training driver: train a ~100M-param qwen2-family model for a few
hundred steps on the synthetic pipeline.

Run:    PYTHONPATH=src python -m repro_torch.examples.train_lm            (~30M, 60 steps)
        PYTHONPATH=src python -m repro_torch.examples.train_lm --full     (~100M, 200 steps)

Demonstrates the production loop surface: deterministic resumable data, AdamW
with fp32 master, checkpointing + restart, straggler/spike guards.  Each run
checkpoints into a fresh temporary directory, removed at the end: a
directory shared between runs would make the next run resume from this
one's last step.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, TrainLoop

SIZES = {   # the reference script's two models, and their steps, batch and sequence
    False: (dict(name="qwen2-30m", num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, d_ff=1024, vocab_size=8_192), 60, 8, 128),
    True: (dict(name="qwen2-100m", num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
                head_dim=64, d_ff=2048, vocab_size=32_000), 200, 8, 256),
}


def config(full: bool = False, **sizes):
    """The example's model: smoke qwen2-72b widened to qwen2-30m (or qwen2-100m)."""
    return dataclasses.replace(get_smoke_config("qwen2-72b"), **(SIZES[bool(full)][0] | sizes))


def run(device="cuda", full: bool = False, steps: int = 0, **sizes) -> dict:
    """Train the example's model on ``device``: qwen2-30m (or qwen2-100m with
    ``full``) at the script's batch and sequence, for the script's steps
    unless ``steps`` is given; ``sizes`` replace fields of the model's
    config.  Returns the parameter count, the steps, the losses and the
    steps at which checkpoints committed."""
    cfg = config(full, **sizes)
    _, n_steps, batch, seq = SIZES[bool(full)]
    steps = steps or n_steps
    with tempfile.TemporaryDirectory(prefix="train_lm_") as ckpt_dir:
        loop = TrainLoop(
            cfg,
            DataConfig(seed=0, global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size),
            TrainConfig(steps=steps, ckpt_every=max(steps // 4, 1), ckpt_dir=ckpt_dir),
            adamw.AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps),
            device=device,
        )
        params, _, history = loop.run(prng.PRNGKey(0))
        committed = loop.ckpt.available_steps()
    return {"n_params": api.param_count(params), "steps": steps,
            "losses": [h["loss"] for h in history], "checkpoints": committed}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params, 200 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=device, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = config(args.full)
    _, n_steps, batch, seq = SIZES[args.full]
    n_params = api.param_count(api.init(cfg, prng.PRNGKey(0), device="meta"))
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, {args.steps or n_steps} steps, "
          f"batch {batch} x seq {seq}")
    r = run(args.device, full=args.full, steps=args.steps)
    losses = r["losses"]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'DECREASED' if losses[-1] < losses[0] else 'no progress'})")
    print(f"checkpoints committed at: {r['checkpoints']}")
    return r


if __name__ == "__main__":
    main()
