"""Serve a small model with batched requests and the paper's timely-reliable
Bayes decision gate (fused posteriors + confidence threshold).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.models import api
from repro_torch.serve import EngineConfig, Request, ServeEngine


def run(device="cuda", arch: str = "qwen2-72b", n_requests: int = 4,
        new_tokens: int = 12) -> dict:
    """The example's serve on ``device`` (the reference: smoke qwen2-72b, 4
    requests of 6-9 prompt tokens, 12 new tokens each)."""
    cfg = get_smoke_config(arch)
    params = api.init(cfg, prng.PRNGKey(0), device=device)
    engine = ServeEngine(
        cfg, params,
        EngineConfig(max_batch=4, t_cache=128, bayes_gate=True, confidence_threshold=0.5),
        device=device,
    )
    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=6 + i).astype(np.int32),
                max_new_tokens=new_tokens)
        for i in range(n_requests)
    ]
    engine.run(prng.PRNGKey(1), requests)
    return {"requests": requests,
            "tokens": np.array([r.out_tokens for r in requests], np.int64),
            "confidences": np.array([r.confidences for r in requests], np.float32)}


def main(device="cuda") -> None:
    r = run(device)
    print("=== batched serving with Bayes-gated emission ===")
    for req in r["requests"]:
        gated = sum(c >= 0.5 for c in req.confidences)
        print(f"request {req.rid}: generated {len(req.out_tokens)} tokens | "
              f"{gated}/{len(req.out_tokens)} emissions cleared the reliability gate | "
              f"mean fused confidence {np.mean(req.confidences):.2f}")
    print("\n(a rejected emission is the LM analogue of the paper's 'keep lane' "
          "branch: the decision is withheld until belief clears the threshold)")


if __name__ == "__main__":
    main()
