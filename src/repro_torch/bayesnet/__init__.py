"""Bayesian-network compiler (DESIGN.md SS8-SS10), in torch.

    spec.py        NetworkSpec / Node -- the source language; nodes carry a
                   cardinality k (binary = the k=2 special case)
    compile.py     the fused lowering (one net_sweep launch per batch, with
                   the decision argmax inside the kernel) or the unfused one
                   (a sne_encode / node_mux launch per node, then the
                   conditioning and a ratio or CORDIV-fill estimate); noise=
                   perturbs every DAC threshold through the crossbar model
    noise.py       NoiseModel: plan-build-time device-to-device / read-noise /
                   IR-drop / stuck-at perturbation of the DAC thresholds
    analytic.py    exact mixed-radix enumeration oracle (noise= gives the
                   perturbed twin) and ancestral sampling of evidence
    reliability.py decision-margin confidence, RetryPolicy, DriftMonitor and
                   the reliability statistics
    scenarios.py   5-12 node driving networks over data/detection statistics
    driver.py      FrameDriver: serve-style batching of evidence frames with
                   power-of-two buckets, non-blocking dispatch on the CUDA
                   stream, confidence-gated retry, fault recovery, swap_net
    calibrate.py   calibrate-back loop: compensated DAC programs, hot
                   recalibration of live drivers, and CPT fitting from the
                   reference's synthetic detection rollouts (keyed draws)
"""

from repro_torch.bayesnet.analytic import make_posterior_fn, sample_evidence  # noqa: F401
from repro_torch.bayesnet.calibrate import (  # noqa: F401
    FITTED_FIELDS,
    calibration_report,
    compensated_program,
    fit_scene_config,
    recalibrate_driver,
    recalibrated_network,
)
from repro_torch.bayesnet.compile import (  # noqa: F401
    CompiledNetwork,
    compile_network,
    posterior_argmax,
    sweep_plan,
)
from repro_torch.bayesnet.driver import FrameDriver  # noqa: F401
from repro_torch.bayesnet.noise import NoiseModel, perturbed_cdf_rows  # noqa: F401
from repro_torch.bayesnet.reliability import (  # noqa: F401
    HEALTH_DRIFTING,
    HEALTH_HEALTHY,
    HEALTH_RECALIBRATING,
    HEALTH_STATES,
    DriftMonitor,
    DriftPolicy,
    FrameReport,
    ReliabilityStats,
    RetryPolicy,
    decision_confidence,
    flip_rate,
)
from repro_torch.bayesnet.scenarios import SCENARIOS, by_name  # noqa: F401
from repro_torch.bayesnet.spec import NetworkSpec, Node  # noqa: F401
