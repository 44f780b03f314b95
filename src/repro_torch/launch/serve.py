"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Batched requests through the ServeEngine with the Bayes-gated timely-reliable
decision head (the paper's operator at the LM decision layer), on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.models import api
from repro_torch.serve import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--no-gate", action="store_true")
    ap.add_argument("--stochastic-gate", action="store_true",
                    help="gate through the fused bayes_decide kernel "
                         "(the paper's SC circuit) instead of the analytic path")
    ap.add_argument("--gate-bits", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.gate_bits % 32 != 0 or args.gate_bits <= 0:
        ap.error(f"--gate-bits must be a positive multiple of 32 "
                 f"(got {args.gate_bits}); the packed pipeline consumes whole "
                 f"32-bit entropy words")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = api.init(cfg, prng.PRNGKey(0), device=args.device)
    engine = ServeEngine(
        cfg, params,
        EngineConfig(
            max_batch=args.requests, t_cache=128,
            bayes_gate=not args.no_gate, confidence_threshold=args.threshold,
            stochastic_gate=args.stochastic_gate, gate_n_bits=args.gate_bits,
        ),
        device=args.device,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    engine.run(prng.PRNGKey(1), reqs)
    for r in reqs:
        reliable = sum(c >= args.threshold for c in r.confidences)
        print(f"req {r.rid}: {len(r.out_tokens)} tokens, "
              f"{reliable}/{len(r.confidences)} cleared the reliability gate, "
              f"mean conf {np.mean(r.confidences):.2f}")
    return reqs


if __name__ == "__main__":
    main()
