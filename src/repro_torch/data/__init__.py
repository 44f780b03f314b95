"""Synthetic data: the scene configuration and the RGB/thermal scenes
(``detection``), and the LM training pipeline (``pipeline``)."""

from repro_torch.data import detection, pipeline  # noqa: F401
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_at_step  # noqa: F401
