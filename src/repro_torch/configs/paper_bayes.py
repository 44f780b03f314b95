"""paper-bayes-fusion: the paper's own workload as a selectable config.

Large-scale RGB+thermal Bayesian fusion over per-pixel class-probability maps
(the Movie-S1 simulation): M modalities x K classes x HxW pixels per frame,
through the stochastic (SNE + AND + popcount, or the fused ``bayes_decide``)
or the analytic (eq 5, ``fusion_map``) path.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class BayesFusionConfig:
    name: str = "paper-bayes-fusion"
    family: str = "bayes"
    modalities: int = 2
    classes: int = 16
    height: int = 1080
    width: int = 1920
    n_bits: int = 128           # stochastic-number length (paper: 100, padded to
                                # whole 32-bit words for the packed path)
    frames_per_batch: int = 8


def full_config() -> BayesFusionConfig:
    return BayesFusionConfig()


def smoke_config() -> BayesFusionConfig:
    return BayesFusionConfig(
        name="paper-bayes-smoke", height=32, width=32, classes=4, n_bits=64,
        frames_per_batch=2,
    )
