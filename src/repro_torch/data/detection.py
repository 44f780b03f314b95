"""Synthetic FLIR-like RGB/thermal detection maps (the Fig 4 / Movie S1 data).

The real FLIR dataset is not available offline; aligned RGB/thermal per-pixel
obstacle-probability maps are generated with the failure modes the paper
describes: RGB misses targets at night or in harsh lighting, thermal misses
targets without heat emission.  Ground truth is known, so the fusion's gain
in detection rate and confidence is measurable.

:func:`make_scene` draws from an explicit ``torch.Generator``; it cannot
reproduce the reference's ``jax.random`` draws, only their distribution.
:func:`make_scene_keyed` takes a key as the reference's ``make_scene`` does
and gives its scene bit for bit.
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


def make_scene(gen: torch.Generator, cfg: SceneConfig, *, device="cuda"):
    """Returns (gt (H, W) {0,1}, p_rgb (H, W), p_thermal (H, W), night flag).

    Draws on the generator's device, then moves the maps to ``device``.
    Failure modes are independent per obstacle and per modality (the paper's
    Fig 4 setting): a missed target yields a *weak* confidence around 0.5
    (insufficient evidence), so conditionally-independent fusion (eq 5) can
    recover targets that either single modality loses.
    """
    dev = resolve_device(device)
    h, w, n = cfg.height, cfg.width, cfg.n_obstacles
    draw = dict(generator=gen, device=gen.device)
    cy = torch.randint(4, h - 4, (n,), **draw)
    cx = torch.randint(4, w - 4, (n,), **draw)
    rad = torch.randint(2, 6, (n,), **draw)
    night = torch.rand((), **draw) < cfg.night_fraction
    rgb_vis = torch.where(night, cfg.rgb_vis_night, cfg.rgb_vis_day)
    rgb_clear = torch.rand((n,), **draw) < rgb_vis
    th_clear = torch.rand((n,), **draw) < cfg.thermal_vis
    noise = 0.06 * torch.rand((2, h, w), **draw)
    cy, cx, rad, night, rgb_clear, th_clear, noise = (
        t.to(dev) for t in (cy, cx, rad, night, rgb_clear, th_clear, noise))

    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    dist2 = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2
    inside = dist2 <= rad[:, None, None] ** 2                       # (N, H, W)
    gt = inside.any(0).to(torch.float32)

    rgb_strength = torch.where(rgb_clear, cfg.strong, cfg.weak)[:, None, None]
    th_strength = torch.where(th_clear, cfg.strong, cfg.weak)[:, None, None]
    rgb_det = (inside * rgb_strength).amax(0)
    th_det = (inside * th_strength).amax(0)

    p_rgb = torch.clamp(rgb_det * (1 - noise[0]) + noise[0] * 0.5, 0.02, 0.98)
    p_th = torch.clamp(th_det * (1 - noise[1]) + noise[1] * 0.5, 0.02, 0.98)
    # background base rate
    p_rgb = torch.where(gt > 0, p_rgb, 0.05 + noise[0])
    p_th = torch.where(gt > 0, p_th, 0.05 + noise[1])
    return gt, p_rgb, p_th, night


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


def make_scene_keyed(key, cfg: SceneConfig, *, device="cuda"):
    """:func:`make_scene` drawn from a ``(2,)`` uint32 key, as the reference's.

    The draws are the reference's, value for value: the key splits into 7,
    obstacle centres and radii come from :func:`~repro_torch.core.prng.randint`
    and the night flag, the per-obstacle visibility and the pixel noise from
    :func:`~repro_torch.core.prng.uniform`, on the host.  The maps are then
    computed on ``device`` in float32, one rounding per operation as the
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
    noise = f32(0.06) * prng.uniform(k6, (2, h, w))
    cy, cx, rad, rgb_clear, th_clear, noise = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (cy, cx, rad, rgb_clear, th_clear, noise))

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
