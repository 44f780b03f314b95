from repro_torch.kernels.sne_encode.ops import sne_encode  # noqa: F401
from repro_torch.kernels.sne_encode.ref import sne_encode_ref  # noqa: F401
