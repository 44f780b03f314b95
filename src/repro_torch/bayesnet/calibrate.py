"""Calibrate-back: fit CPTs from data, pre-distort thresholds, hot-recalibrate.

The closing arc of the crossbar-health loop (DESIGN §15).  The drift layers
below this module *observe* an aging array -- epoched lowering bakes
within-launch drift into the plan (:mod:`repro_torch.bayesnet.compile`), the
:class:`~repro_torch.bayesnet.reliability.DriftMonitor` detects it online --
and this module *acts*:

**Compensation** (:func:`compensated_program`).  The deterministic part of
the noise model -- device-to-device lognormal spread, wear-scaled read noise,
IR droop (:meth:`~repro_torch.bayesnet.noise.NoiseModel.error_factors`) -- is
a known multiplicative error on every programmed DAC threshold.  Dividing the
clean thresholds by the predicted factors *before* programming makes the
perturbation land back on the clean values: the programmed array then
samples (to within one DAC step of rounding) the distribution the spec
asked for.  Stuck devices are faults, not drift, and are deliberately not
compensated.  d2d and IR are cycle-independent, so compensation always
helps; the read-noise term grows with wear and only cancels at the cycle it
was fitted for -- which is why recalibration must be *periodic*.

**Hot recalibration** (:func:`recalibrated_network` /
:func:`recalibrate_driver`).  Re-lower the network at the current estimated
cycle with the compensated program, on the network's own device, and swap
it into a live :class:`~repro_torch.bayesnet.driver.FrameDriver` between
launches (:meth:`~repro_torch.bayesnet.driver.FrameDriver.swap_net`):
in-flight launches harvest against their original plan, queued frames ride
the new one, zero frames lost or reordered.  The driver's launch counter
doubles as the cycle estimate -- one launch, one read of every device.  On
the card the twin's fused plan is a new ``net_sweep`` program (its
thresholds are literals of the generated kernel), so the re-lowering runs
``nvcc`` once, where the call is made.

**CPT fitting from rollouts** (:func:`fit_scene_config` /
:func:`calibration_report`).  The scenario CPTs are parameterised by a
:class:`~repro_torch.data.detection.SceneConfig`; instead of trusting the
hand-set values, count confusion statistics over synthetic detection
rollouts (:func:`~repro_torch.data.detection.make_scene`, the
reference's draws from the same key) and invert the generator's known
observation bias to recover the config.  ``calibration_report`` quantifies
the fit's bias/variance against the hand-set reference and the resulting
DAC-threshold deviation of every scenario network's CPTs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.bayesnet.compile import CompiledNetwork, compile_network
from repro_torch.bayesnet.noise import NoiseModel
from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import prng, rng
from repro_torch.data.detection import SceneConfig, detection_metrics, make_scene

# make_scene blends 6% uniform noise toward 0.5 into every detector pixel:
# E[p | strength s] = s (1 - E[u]) + 0.5 E[u] with u ~ U(0, 0.06), so the
# observed mean is 0.97 s + 0.015 -- inverted exactly by the fitters below.
_NOISE_GAIN = 1.0 - 0.06 / 2.0
_NOISE_BIAS = 0.5 * 0.06 / 2.0

# SceneConfig fields the rollout fit estimates (the CPT parameterisation).
FITTED_FIELDS: Tuple[str, ...] = (
    "night_fraction", "rgb_vis_day", "rgb_vis_night",
    "thermal_vis", "strong", "weak",
)


def _debias(mean_p: float) -> float:
    """Invert the generator's noise blend: observed mean -> detector strength."""
    return float(np.clip((mean_p - _NOISE_BIAS) / _NOISE_GAIN, 0.02, 0.98))


# --------------------------------------------------------------- compensation
def compensated_program(
    spec: NetworkSpec,
    noise: NoiseModel,
    cycle: float | None = None,
    drift_epochs: int = 1,
) -> Dict[str, tuple]:
    """Pre-distorted DAC thresholds that cancel the predicted drift.

    For every node the clean CDF thresholds are divided by the noise model's
    deterministic multiplicative error at ``cycle`` (default the model's own
    cycle), rounded back to the 8-bit grid, and re-monotonised -- so after
    the hardware applies the same error, the effective thresholds land
    within one DAC step of clean.  Returns a ``name -> rows`` program dict
    for ``compile_network(program=...)`` /
    ``perturbed_cdf_rows(program=...)``.

    ``drift_epochs=E > 1`` fits the program the epoched plan will actually
    run: the stream spans snapshots at ``cycle .. cycle+E-1``, each with its
    own read-noise realization, but the hardware programs *one* conductance
    per threshold -- so the best one-shot program divides by the **geometric
    mean** of the per-epoch factors.
    """
    if noise is None:
        raise ValueError("compensated_program needs a NoiseModel")
    drift_epochs = int(drift_epochs)
    if drift_epochs < 1:
        raise ValueError(f"drift_epochs must be >= 1, got {drift_epochs}")
    nm = noise if cycle is None else noise.with_cycle(cycle)
    epoch_models = [nm.with_cycle(nm.cycle + e) for e in range(drift_epochs)]
    order = spec.topo_order()
    program: Dict[str, tuple] = {}
    for pos, name in enumerate(order):
        clean = np.asarray(
            [rng.cdf_thresholds_int(row) for row in spec.cpt_rows(name)], np.float64
        )
        if clean.size:
            log_f = np.mean(
                [np.log(m.error_factors(name, clean.shape[0], clean.shape[1], pos,
                                        len(order)))
                 for m in epoch_models],
                axis=0,
            )
            prog = np.clip(np.rint(clean / np.exp(log_f)), 0.0, 256.0)
            prog = np.minimum.accumulate(prog, axis=1)
        else:
            prog = clean
        program[name] = tuple(tuple(int(v) for v in row) for row in prog.astype(np.int64))
    return program


def recalibrated_network(net: CompiledNetwork, cycle: float | None = None) -> CompiledNetwork:
    """Re-lower ``net`` at ``cycle`` with a freshly compensated program.

    The returned network has the same spec / queries / evidence / stream
    length / device as ``net`` -- a drop-in
    :meth:`~repro_torch.bayesnet.driver.FrameDriver.swap_net` target -- but
    its noise model is advanced to ``cycle`` and its thresholds are
    programmed to cancel that cycle's predicted drift.  As the reference's,
    it passes neither ``mux_mode`` nor ``trace``: a ``mux_mode='rows'``
    network recalibrates to the default gather lowering.
    """
    if net.noise is None:
        raise ValueError(
            "recalibrated_network needs a noisy network (net.noise is None): "
            "there is no drift to calibrate back"
        )
    nm = net.noise.with_cycle(net.noise.cycle if cycle is None else cycle)
    return compile_network(
        net.spec, net.n_bits, net.queries, net.evidence,
        share_entropy=net.share_entropy, estimator=net.estimator,
        fused=net.fused, noise=nm, drift_epochs=net.drift_epochs,
        program=compensated_program(net.spec, nm, drift_epochs=net.drift_epochs),
        devices=max(net.n_shards, 1), device=net.device,
    )


def recalibrate_driver(driver, cycle: float | None = None) -> CompiledNetwork:
    """Recalibrate a live driver in place; returns the swapped-in network.

    ``cycle=None`` uses ``driver.launches`` as the cycle estimate (one
    launch = one read of every device in the array).  The swap happens
    between launches: zero frames lost, zero reordered.
    """
    c = float(driver.launches if cycle is None else cycle)
    net = recalibrated_network(driver.net, c)
    driver.swap_net(net)
    return net


# ------------------------------------------------------------ rollout fitting
def fit_scene_config(
    key,
    cfg: SceneConfig | None = None,
    n_scenes: int = 48,
    thresh: float = 0.6,
    *,
    device="cuda",
) -> SceneConfig:
    """Fit the CPT parameterisation from counted rollout confusion statistics.

    Generates ``n_scenes`` synthetic detection scenes from ``cfg`` (the
    data-generating truth; default hand-set) on ``device``, one per key of
    ``prng.split(key, n_scenes)``, and estimates every :data:`FITTED_FIELDS`
    entry from observable statistics only:

    * ``night_fraction`` -- fraction of scenes flagged night;
    * ``rgb_vis_day`` / ``rgb_vis_night`` -- RGB ground-truth-pixel
      detection rate on day / night scenes;
    * ``thermal_vis`` -- thermal detection rate over all scenes;
    * ``strong`` / ``weak`` -- mean detector probability on hit / missed
      target pixels, debiased through the generator's known 6% noise blend.

    Returns a :class:`~repro_torch.data.detection.SceneConfig` with the
    fitted fields replaced (geometry fields pass through).
    """
    cfg = cfg if cfg is not None else SceneConfig()
    if n_scenes < 2:
        raise ValueError(f"n_scenes must be >= 2, got {n_scenes}")
    day_tp, night_tp, th_tp = [], [], []
    hit_sum = hit_n = miss_sum = miss_n = 0.0
    n_night = 0
    for k in prng.split(key, n_scenes):
        gt, p_rgb, p_th, night = make_scene(k, cfg, device=device)
        n_night += night
        tp_r, _, _ = detection_metrics(gt, p_rgb, thresh)
        tp_t, _, _ = detection_metrics(gt, p_th, thresh)
        (night_tp if night else day_tp).append(float(tp_r))
        th_tp.append(float(tp_t))
        gt = gt.cpu().numpy()
        for p in (p_rgb.cpu().numpy(), p_th.cpu().numpy()):
            on = p[gt > 0]
            hits = on[on > thresh]
            misses = on[on <= thresh]
            hit_sum += float(hits.sum()); hit_n += hits.size
            miss_sum += float(misses.sum()); miss_n += misses.size
    return dataclasses.replace(
        cfg,
        night_fraction=n_night / n_scenes,
        rgb_vis_day=float(np.mean(day_tp)) if day_tp else cfg.rgb_vis_day,
        rgb_vis_night=float(np.mean(night_tp)) if night_tp else cfg.rgb_vis_night,
        thermal_vis=float(np.mean(th_tp)) if th_tp else cfg.thermal_vis,
        strong=_debias(hit_sum / hit_n) if hit_n else cfg.strong,
        weak=_debias(miss_sum / miss_n) if miss_n else cfg.weak,
    )


def calibration_report(
    key,
    reference: SceneConfig | None = None,
    n_scenes: int = 48,
    repeats: int = 3,
    thresh: float = 0.6,
    *,
    device="cuda",
) -> dict:
    """Bias/variance of the rollout fit vs the hand-set CPT parameters.

    Runs ``repeats`` independent fits of ``n_scenes`` scenes each (on
    ``device``) and reports, per fitted field, the reference value, fit mean,
    bias and spread -- plus, per scenario network, the maximum absolute 8-bit
    DAC threshold deviation between CPTs built from the mean fitted config
    and from the reference: a deviation of ``d`` DAC steps means the fitted
    network programs thresholds at most ``d/256`` of probability away from
    the hand-set one.
    """
    from repro_torch.bayesnet.scenarios import SCENARIOS, by_name

    reference = reference if reference is not None else SceneConfig()
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    fits = [
        fit_scene_config(k, reference, n_scenes, thresh, device=device)
        for k in prng.split(key, repeats)
    ]
    fields: Dict[str, dict] = {}
    mean_vals: Dict[str, float] = {}
    for f in FITTED_FIELDS:
        vals = np.asarray([getattr(c, f) for c in fits], np.float64)
        ref = float(getattr(reference, f))
        mean_vals[f] = float(vals.mean())
        fields[f] = {
            "reference": ref,
            "mean": float(vals.mean()),
            "bias": float(vals.mean() - ref),
            "std": float(vals.std()),
        }
    mean_cfg = dataclasses.replace(reference, **mean_vals)
    scen_dev: Dict[str, int] = {}
    for name in SCENARIOS:
        ref_spec = by_name(name, reference)
        fit_spec = by_name(name, mean_cfg)
        dev = 0
        for node in ref_spec.topo_order():
            ref_rows = [rng.cdf_thresholds_int(r) for r in ref_spec.cpt_rows(node)]
            fit_rows = [rng.cdf_thresholds_int(r) for r in fit_spec.cpt_rows(node)]
            for rr, fr in zip(ref_rows, fit_rows):
                for a, b in zip(rr, fr):
                    dev = max(dev, abs(int(a) - int(b)))
        scen_dev[name] = dev
    return {
        "n_scenes": int(n_scenes),
        "repeats": int(repeats),
        "fields": fields,
        "scenario_dac_deviation": scen_dev,
        "max_dac_deviation": max(scen_dev.values()) if scen_dev else 0,
    }
