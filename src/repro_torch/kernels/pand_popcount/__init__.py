from repro_torch.kernels.pand_popcount.ops import pand_popcount  # noqa: F401
from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref  # noqa: F401
