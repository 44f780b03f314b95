"""Selectable configurations of the port: the ten LM architectures (each
module's ``full_config`` at its published widths and a ``smoke_config``) and
the paper's own workload (``paper_bayes``), by ``--arch`` id."""

from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, ModelConfig, MoEConfig, ShapeConfig  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
