from repro_torch.optim import adamw, compression  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig, OptState  # noqa: F401
