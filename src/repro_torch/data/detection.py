"""Synthetic FLIR-like RGB/thermal detection maps (the Fig 4 / Movie S1 data).

The real FLIR dataset is not available offline; aligned RGB/thermal per-pixel
obstacle-probability maps are generated with the failure modes the paper
describes: RGB misses targets at night or in harsh lighting, thermal misses
targets without heat emission.  Ground truth is known, so the fusion's gain
in detection rate and confidence is measurable.

:func:`make_scene` takes a key as the reference's does and gives its scene
bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    height: int = 64
    width: int = 64
    n_obstacles: int = 6
    night_fraction: float = 0.5     # scenes at night (RGB visibility drops)
    rgb_vis_day: float = 0.95       # P(obstacle clearly visible to RGB), day
    rgb_vis_night: float = 0.50     # ... at night (harsh lighting, low light)
    thermal_vis: float = 0.55       # P(clear heat signature) -- cold targets
    strong: float = 0.85            # detector confidence on a clear target
    weak: float = 0.52              # "insufficient evidence", NOT a confident
                                    # rejection -- the regime fusion can rescue


def detection_metrics(gt: torch.Tensor, p: torch.Tensor, thresh: float = 0.6):
    """(detection rate on gt pixels, false-positive rate, mean confidence on gt)."""
    gt = torch.as_tensor(gt, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=gt.device)
    det = (p > thresh).to(torch.float32)
    n_gt = torch.clamp(gt.sum(), min=1)
    tp = (det * gt).sum() / n_gt
    fp = (det * (1 - gt)).sum() / torch.clamp((1 - gt).sum(), min=1)
    conf = (p * gt).sum() / n_gt
    return tp, fp, conf


def make_scene(key, cfg: SceneConfig, *, device="cuda"):
    """Returns (gt (H, W) {0,1}, p_rgb (H, W), p_thermal (H, W), night flag).

    Failure modes are independent per obstacle and per modality (the paper's
    Fig 4 setting): a missed target yields a *weak* confidence around 0.5
    (insufficient evidence), so conditionally-independent fusion (eq 5) can
    recover targets that either single modality loses.

    The draws are the reference's, value for value, from the ``(2,)``
    uint32 key: it splits into 7; obstacle centres and radii come from
    :func:`~repro_torch.core.prng.randint` and the night flag and the
    per-obstacle visibility from :func:`~repro_torch.core.prng.uniform`, on
    the host (a handful of values), the pixel noise from
    :func:`~repro_torch.core.prng.device_uniform` on ``device``.  The maps
    are computed on ``device`` in float32, one rounding per operation as the
    reference's, so the same key gives the reference's scene bit for bit on
    the card and on the CPU.
    """
    dev = resolve_device(device)
    k1, k2, k3, k4, k5, k6, k7 = prng.split(key, 7)
    h, w, n = cfg.height, cfg.width, cfg.n_obstacles
    cy = prng.randint(k1, (n,), 4, h - 4)
    cx = prng.randint(k2, (n,), 4, w - 4)
    rad = prng.randint(k3, (n,), 2, 6)
    f32 = np.float32
    night = bool(prng.uniform(k5, ()) < f32(cfg.night_fraction))
    rgb_vis = f32(cfg.rgb_vis_night if night else cfg.rgb_vis_day)
    rgb_clear = prng.uniform(k4, (n,)) < rgb_vis
    th_clear = prng.uniform(k7, (n,)) < f32(cfg.thermal_vis)
    noise = torch.tensor(f32(0.06), device=dev) * prng.device_uniform(k6, (2, h, w), device=dev)
    cy, cx, rad, rgb_clear, th_clear = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (cy, cx, rad, rgb_clear, th_clear))

    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    dist2 = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2
    inside = dist2 <= rad[:, None, None] ** 2                       # (N, H, W)
    gt = inside.any(0).to(torch.float32)

    strong, weak = (torch.tensor(f32(v), device=dev) for v in (cfg.strong, cfg.weak))
    rgb_det = (inside * torch.where(rgb_clear, strong, weak)[:, None, None]).amax(0)
    th_det = (inside * torch.where(th_clear, strong, weak)[:, None, None]).amax(0)

    half, lo, hi, base = (torch.tensor(f32(v), device=dev) for v in (0.5, 0.02, 0.98, 0.05))
    one = torch.tensor(f32(1.0), device=dev)
    p_rgb = torch.clamp(rgb_det * (one - noise[0]) + noise[0] * half, lo, hi)
    p_th = torch.clamp(th_det * (one - noise[1]) + noise[1] * half, lo, hi)
    # background base rate
    p_rgb = torch.where(gt > 0, p_rgb, base + noise[0])
    p_th = torch.where(gt > 0, p_th, base + noise[1])
    return gt, p_rgb, p_th, night
