"""Scenario library: driving decision networks over the paper's sensor models.

Each builder returns a :class:`~repro_torch.bayesnet.spec.NetworkSpec` (5-12 nodes)
whose sensor CPTs are taken from the synthetic FLIR statistics in
``repro_torch.data.detection.SceneConfig`` -- RGB visibility collapsing at night,
thermal missing cold targets, detector confidences ``strong``/``weak`` -- so
the compiled networks face exactly the failure modes the paper's fusion
operator is built to survive.  Evidence sets name the observable sensor nodes;
query sets name the latent state and the downstream decision.

The first four networks are all-binary (and stay bit-identical to the
pre-categorical compiler).  The categorical trio models the multi-class
structure the road scenes actually have -- obstacle *type* instead of
obstacle towers-of-booleans, a three-state traffic signal, class-confusion
detector reports -- exercising every k-ary path: k-ary roots, k-ary CPT
parents, k-ary evidence, and k-ary (vector-posterior) queries.

``SCENARIOS`` maps scenario id -> builder; ``by_name`` resolves one.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.bayesnet.spec import NetworkSpec, Node
from repro_torch.data.detection import SceneConfig

_CFG = SceneConfig()


def sensor_degradation(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """5 nodes: is a disagreeing sensor pair degraded, or is the world hot?"""
    return NetworkSpec(
        name="sensor-degradation",
        nodes=(
            Node("degraded", (), (0.08,)),
            Node("heat", (), (0.30,)),
            # CPT rows ordered (degraded, heat) = 00, 01, 10, 11
            Node("reading_a", ("degraded", "heat"), (0.03, cfg.strong, 0.40, cfg.weak)),
            Node("reading_b", ("degraded", "heat"), (0.05, cfg.strong, 0.45, cfg.weak)),
            Node("agree", ("reading_a", "reading_b"), (0.95, 0.10, 0.10, 0.95)),
        ),
        evidence=("reading_a", "reading_b"),
        queries=("degraded", "heat"),
    )


def pedestrian_night(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """8 nodes: the Fig 4 night-pedestrian setting as a full network.

    RGB visibility drops from ``rgb_vis_day`` to ``rgb_vis_night`` after dark;
    thermal only sees warm targets; the brake decision fuses both detectors.
    """
    return NetworkSpec(
        name="pedestrian-night",
        nodes=(
            Node("night", (), (cfg.night_fraction,)),
            Node("pedestrian", (), (0.20,)),
            Node("warm", (), (0.70,)),
            # (pedestrian, night) = 00, 01, 10, 11
            Node("rgb_visible", ("pedestrian", "night"),
                 (0.02, 0.02, cfg.rgb_vis_day, cfg.rgb_vis_night)),
            # (pedestrian, warm) = 00, 01, 10, 11
            Node("th_visible", ("pedestrian", "warm"),
                 (0.03, 0.03, 0.30, cfg.strong)),
            Node("rgb_detect", ("rgb_visible",), (0.08, cfg.strong)),
            Node("th_detect", ("th_visible",), (0.08, cfg.strong)),
            # (rgb_detect, th_detect) = 00, 01, 10, 11
            Node("brake", ("rgb_detect", "th_detect"), (0.02, 0.70, 0.75, 0.98)),
        ),
        evidence=("night", "rgb_detect", "th_detect"),
        queries=("pedestrian", "brake"),
    )


def lane_change(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """9 nodes: the paper's keep-lane / change-lane decision with radar+camera."""
    return NetworkSpec(
        name="lane-change",
        nodes=(
            Node("overtaker", (), (0.25,)),
            Node("night", (), (cfg.night_fraction,)),
            Node("sensor_fault", (), (0.05,)),
            Node("gap_ahead", (), (0.60,)),
            # (overtaker, sensor_fault) = 00, 01, 10, 11
            Node("radar_echo", ("overtaker", "sensor_fault"),
                 (0.06, 0.30, 0.92, cfg.weak)),
            # (overtaker, night) = 00, 01, 10, 11
            Node("camera_blob", ("overtaker", "night"),
                 (0.05, 0.08, 0.90, cfg.rgb_vis_night)),
            Node("blindspot_warn", ("radar_echo",), (0.04, 0.95)),
            # (overtaker, gap_ahead) = 00, 01, 10, 11
            Node("safe", ("overtaker", "gap_ahead"), (0.35, 0.95, 0.02, 0.15)),
            # (safe, blindspot_warn) = 00, 01, 10, 11
            Node("change_lane", ("safe", "blindspot_warn"), (0.10, 0.01, 0.90, 0.20)),
        ),
        evidence=("night", "camera_blob", "blindspot_warn", "gap_ahead"),
        queries=("overtaker", "safe", "change_lane"),
    )


def intersection(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """12 nodes: right-of-way at an intersection, three-parent sensor CPTs."""
    return NetworkSpec(
        name="intersection",
        nodes=(
            Node("signal_green", (), (0.50,)),
            Node("occlusion", (), (0.30,)),
            Node("night", (), (cfg.night_fraction,)),
            Node("cross_traffic", ("signal_green",), (0.50, 0.10)),
            Node("ped_crossing", ("signal_green",), (0.15, 0.05)),
            # (cross_traffic, occlusion, night) = 000 .. 111
            Node("rgb_cross", ("cross_traffic", "occlusion", "night"),
                 (0.04, 0.04, 0.03, 0.03,
                  cfg.rgb_vis_day, cfg.rgb_vis_night, 0.40, 0.25)),
            # (cross_traffic, occlusion) = 00, 01, 10, 11
            Node("radar_cross", ("cross_traffic", "occlusion"),
                 (0.05, 0.08, 0.93, 0.60)),
            # (ped_crossing, night) = 00, 01, 10, 11
            Node("rgb_ped", ("ped_crossing", "night"),
                 (0.03, 0.03, cfg.rgb_vis_day, cfg.rgb_vis_night)),
            Node("th_ped", ("ped_crossing",), (0.06, 0.80)),
            Node("horn", ("cross_traffic",), (0.02, 0.25)),
            # (signal_green, cross_traffic, ped_crossing) = 000 .. 111
            Node("right_of_way", ("signal_green", "cross_traffic", "ped_crossing"),
                 (0.10, 0.03, 0.02, 0.01, 0.97, 0.30, 0.20, 0.05)),
            # (right_of_way, occlusion) = 00, 01, 10, 11
            Node("proceed", ("right_of_way", "occlusion"), (0.05, 0.02, 0.95, 0.60)),
        ),
        evidence=("night", "rgb_cross", "radar_cross", "rgb_ped", "th_ped", "horn"),
        queries=("cross_traffic", "ped_crossing", "proceed"),
    )


# --- categorical scenarios ---------------------------------------------------------

# Obstacle classes shared by the categorical nets (the paper's road agents).
OBSTACLE_CLASSES = ("none", "pedestrian", "vehicle", "cyclist")


def obstacle_class(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """6 nodes, 4-class: *what* is ahead, not just whether something is.

    ``obstacle`` is a single cardinality-4 node; each detector reports a
    class-confusion distribution (k-ary CPT rows) instead of a bit.  RGB
    confuses cyclists with pedestrians and collapses at night; thermal sees
    warm signatures (pedestrian/cyclist small, vehicle engine large); radar
    returns echo strength by cross-section.  The net answers the full
    classification posterior plus the derived alert decision.
    """
    return NetworkSpec(
        name="obstacle-class",
        nodes=(
            # (none, pedestrian, vehicle, cyclist)
            Node.categorical("obstacle", (), ((0.55, 0.18, 0.17, 0.10),)),
            Node("night", (), (cfg.night_fraction,)),
            # rgb_class: reported class, rows = (obstacle, night) mixed-radix.
            # Day diagonals track cfg.rgb_vis_day (0.95 scaled by class
            # difficulty); night rows collapse toward "none" as visibility
            # drops to cfg.rgb_vis_night.
            Node.categorical("rgb_class", ("obstacle", "night"), (
                (0.92, 0.03, 0.03, 0.02),   # none, day
                (0.97, 0.01, 0.01, 0.01),   # none, night
                (0.06, 0.75, 0.04, 0.15),   # ped, day: cyclist confusion
                (0.52, 0.35, 0.03, 0.10),   # ped, night
                (0.04, 0.02, 0.90, 0.04),   # vehicle, day
                (0.35, 0.05, 0.50, 0.10),   # vehicle, night
                (0.08, 0.22, 0.10, 0.60),   # cyclist, day
                (0.60, 0.15, 0.05, 0.20),   # cyclist, night
            )),
            # th_signature: (cold, warm-small, warm-large) by obstacle class
            Node.categorical("th_signature", ("obstacle",), (
                (0.90, 0.07, 0.03),          # none
                (0.10, 0.75, 0.15),          # pedestrian: small warm blob
                (0.25, 0.15, 0.60),          # vehicle: large engine signature
                (0.15, 0.65, 0.20),          # cyclist
            )),
            # radar_echo: (none, weak, strong) by radar cross-section
            Node.categorical("radar_echo", ("obstacle",), (
                (0.88, 0.10, 0.02),          # none
                (0.55, 0.40, 0.05),          # pedestrian: tiny cross-section
                (0.04, 0.16, 0.80),          # vehicle
                (0.25, 0.55, 0.20),          # cyclist
            )),
            Node("alert", ("obstacle",), (
                (0.97, 0.03), (0.03, 0.97), (0.25, 0.75), (0.05, 0.95),
            ), k=2),
        ),
        evidence=("night", "rgb_class", "th_signature", "radar_echo"),
        queries=("obstacle", "alert"),
    )


def obstacle_detection(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """7 nodes: the night-pedestrian net recast categorically.

    A 3-state ``light`` regime (day/dusk/night) replaces the binary night
    flag, and the 4-class ``obstacle`` replaces the pedestrian boolean tower;
    the binary detectors hang off k-ary parents (mixed-radix CPT rows), so
    this net exercises binary children of categorical causes.
    """
    nf = cfg.night_fraction
    return NetworkSpec(
        name="obstacle-detection",
        nodes=(
            # (day, dusk, night)
            Node.categorical("light", (), ((1.0 - 0.15 - nf, 0.15, nf),)),
            Node.categorical("obstacle", (), ((0.55, 0.18, 0.17, 0.10),)),
            # warm: thermal-visible signature by class
            Node("warm", ("obstacle",), (
                (0.75, 0.25), (0.05, 0.95), (0.45, 0.55), (0.10, 0.90),
            ), k=2),
            # rgb_detect rows = (obstacle, light): day / dusk / night per class
            Node("rgb_detect", ("obstacle", "light"), (
                (0.96, 0.04), (0.95, 0.05), (0.98, 0.02),     # none
                (1.0 - cfg.rgb_vis_day, cfg.rgb_vis_day),     # ped, day
                (0.45, 0.55),                                 # ped, dusk
                (1.0 - cfg.rgb_vis_night, cfg.rgb_vis_night), # ped, night
                (0.08, 0.92), (0.25, 0.75), (0.55, 0.45),     # vehicle
                (0.15, 0.85), (0.40, 0.60), (0.70, 0.30),     # cyclist
            ), k=2),
            Node("th_detect", ("obstacle", "warm"), (
                (0.95, 0.05), (0.80, 0.20),                   # none: cold/warm
                (0.90, 0.10), (1.0 - cfg.strong, cfg.strong), # pedestrian
                (0.85, 0.15), (0.20, 0.80),                   # vehicle
                (0.88, 0.12), (0.12, 0.88),                   # cyclist
            ), k=2),
            Node("radar_detect", ("obstacle",), (
                (0.94, 0.06), (0.65, 0.35), (0.07, 0.93), (0.40, 0.60),
            ), k=2),
            Node("brake", ("obstacle",), (
                (0.97, 0.03), (0.03, 0.97), (0.30, 0.70), (0.08, 0.92),
            ), k=2),
        ),
        evidence=("light", "rgb_detect", "th_detect", "radar_detect"),
        queries=("obstacle", "brake"),
    )


def intersection_cat(cfg: SceneConfig = _CFG) -> NetworkSpec:
    """10 nodes: right-of-way with a first-class 3-state traffic signal.

    The signal (red/yellow/green) is a categorical root observed through a
    class-confusion camera report (k-ary evidence of a k-ary node); the
    latent traffic/pedestrian states and the proceed decision stay binary,
    so the query set mixes a length-3 posterior with classic bits.
    """
    return NetworkSpec(
        name="intersection-cat",
        nodes=(
            # (red, yellow, green)
            Node.categorical("signal", (), ((0.45, 0.10, 0.45),)),
            Node("occlusion", (), (0.30,)),
            Node("night", (), (cfg.night_fraction,)),
            Node("cross_traffic", ("signal",), (
                (0.45, 0.55), (0.65, 0.35), (0.90, 0.10),
            ), k=2),
            Node("ped_crossing", ("signal",), (
                (0.82, 0.18), (0.90, 0.10), (0.95, 0.05),
            ), k=2),
            # rgb_signal rows = (signal, night): camera's reported light state
            Node.categorical("rgb_signal", ("signal", "night"), (
                (0.90, 0.06, 0.04), (0.80, 0.12, 0.08),   # red: day, night
                (0.10, 0.82, 0.08), (0.18, 0.68, 0.14),   # yellow
                (0.04, 0.06, 0.90), (0.10, 0.12, 0.78),   # green
            )),
            # (cross_traffic, occlusion) = 00, 01, 10, 11
            Node("radar_cross", ("cross_traffic", "occlusion"),
                 (0.05, 0.08, 0.93, 0.60)),
            Node("th_ped", ("ped_crossing",), (0.06, 0.80)),
            # (signal, cross_traffic, ped_crossing) mixed-radix, signal MSD
            Node("right_of_way", ("signal", "cross_traffic", "ped_crossing"), (
                (0.90, 0.10), (0.97, 0.03), (0.98, 0.02), (0.99, 0.01),  # red
                (0.60, 0.40), (0.90, 0.10), (0.93, 0.07), (0.97, 0.03),  # yellow
                (0.03, 0.97), (0.70, 0.30), (0.80, 0.20), (0.95, 0.05),  # green
            ), k=2),
            # (right_of_way, occlusion) = 00, 01, 10, 11
            Node("proceed", ("right_of_way", "occlusion"), (0.05, 0.02, 0.95, 0.60)),
        ),
        evidence=("night", "rgb_signal", "radar_cross", "th_ped"),
        queries=("signal", "cross_traffic", "proceed"),
    )


SCENARIOS: Dict[str, Callable[..., NetworkSpec]] = {
    "sensor-degradation": sensor_degradation,
    "pedestrian-night": pedestrian_night,
    "lane-change": lane_change,
    "intersection": intersection,
    "obstacle-class": obstacle_class,
    "obstacle-detection": obstacle_detection,
    "intersection-cat": intersection_cat,
}


def by_name(name: str, cfg: SceneConfig = _CFG) -> NetworkSpec:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name](cfg)
