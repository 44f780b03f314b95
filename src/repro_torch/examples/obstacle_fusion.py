"""Obstacle detection via RGB + thermal Bayesian fusion (paper Fig 4 / Movie S1)
on a synthetic FLIR-like night scene, through the port's kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.obstacle_fusion
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.data import detection
from repro_torch.kernels import bayes_decide, fusion_map


def run(device="cuda", height: int = 64, width: int = 64, tile: int = 4096,
        tile_bits: int = 256) -> dict:
    """A night scene (key 0), the single-modal and the analytic fused detection
    rates, and the stochastic circuit on the first ``tile`` pixels at
    ``tile_bits`` bits (key 1)."""
    cfg = detection.SceneConfig(height=height, width=width, night_fraction=1.0)
    gt, p_rgb, p_th, _ = detection.make_scene(prng.PRNGKey(0), cfg, device=device)
    # analytic fusion (eq 5) through the fusion_map kernel
    p_modal = torch.stack([torch.stack([q, 1 - q], -1).reshape(-1, 2) for q in (p_rgb, p_th)])
    fused = fusion_map(p_modal, device=device)[:, 0]
    rates = {name: [float(v) for v in detection.detection_metrics(gt, q.reshape(gt.shape))]
             for name, q in (("RGB", p_rgb), ("thermal", p_th), ("fused", fused))}
    # the stochastic circuit on a tile, one fused kernel launch:
    # encode -> AND -> popcount -> argmax
    dec, cnt = bayes_decide(prng.PRNGKey(1), p_modal[:, :tile], tile_bits, device=device)
    cf = cnt.to(torch.float32)
    stoch = cf[:, 0] / cf.sum(-1).clamp(min=1.0)
    ref = fused[:tile]
    return {
        "gt_pixels": int(gt.sum()), "fused": fused, "dec": dec, "cnt": cnt, "rates": rates,
        "mean_abs_err": float((stoch - ref).abs().mean()),
        "agreement": float((dec == (ref < 0.5).to(dec.dtype)).to(torch.float32).mean()),
    }


def main(device="cuda") -> None:
    r = run(device)
    print(f"night scene: {r['gt_pixels']} obstacle pixels")
    for name in ("RGB", "thermal"):
        tp, _, conf = r["rates"][name]
        print(f"  {name:8s}: detection {tp*100:5.1f}%  conf {conf:.2f}")
    tp, _, conf = r["rates"]["fused"]
    print(f"  fused   : detection {tp*100:5.1f}%  conf {conf:.2f}"
          f"   <- recovers targets both modalities are unsure about")
    print(f"\nfused stochastic circuit (256-bit streams) vs analytic fusion: "
          f"mean abs err {r['mean_abs_err']:.3f}, decision agreement {r['agreement']*100:.1f}%")
    print("(the hardware operator is this pipeline with memristor entropy; "
          "<0.4 ms/frame at 100-bit on the paper's substrate)")


if __name__ == "__main__":
    main()
