"""Synthetic FLIR-like detection statistics (the Fig 4 / Movie S1 data).

Only the scene configuration is ported so far: the scenario networks take
their sensor CPTs from it.  The per-pixel rollout synthesis that draws scenes
from it is still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses


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
