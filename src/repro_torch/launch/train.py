"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Single-device driver with the reference's fault-tolerance surface:
deterministic resumable data, async checkpointing, preemption guard,
straggler watch, loss-spike rewind (see train/loop.py), on the card unless
``--device cpu``.  ``--smoke`` trains the reduced config; a full config
trains at its published size where it fits the card (``ckpt_every`` is a
quarter of the steps, and each checkpoint holds the whole state).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, TrainLoop


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resumes from the newest checkpoint there; default: a new directory")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def data_config(cfg, global_batch: int, seq_len: int) -> DataConfig:
    """The launcher's data: seed 0, the model's vocabulary and stub frontend
    (4 patches, or a frame per ``enc_ratio`` tokens)."""
    return DataConfig(
        seed=0, global_batch=global_batch, seq_len=seq_len,
        vocab_size=cfg.vocab_size,
        frontend=cfg.frontend,
        n_extra=(4 if cfg.frontend == "patch"
                 else seq_len // cfg.enc_ratio if cfg.frontend == "frame" else 0),
        d_model=cfg.d_model,
    )


def setup(argv=None):
    """The launcher's flags -> (args, model config, DataConfig, TrainConfig,
    AdamWConfig)."""
    args = _parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = data_config(cfg, args.global_batch, args.seq_len)
    train_cfg = TrainConfig(
        steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
    )
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps)
    return args, cfg, data_cfg, train_cfg, opt_cfg


def main(argv=None):
    args, cfg, data_cfg, train_cfg, opt_cfg = setup(argv)
    loop = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device=args.device)
    loop.guard.__init__(install=True)  # SIGTERM -> checkpoint + clean exit
    try:
        _, _, history = loop.run(prng.PRNGKey(0))
    finally:
        loop.guard.restore()
    print(f"arch={cfg.name} steps={len(history)} "
          f"first_loss={history[0]['loss']:.3f} last_loss={history[-1]['loss']:.3f}")
    if loop.straggler.flagged_steps:
        print(f"straggler-flagged steps: {loop.straggler.flagged_steps}")
    return history


if __name__ == "__main__":
    main()
