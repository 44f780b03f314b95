from repro_torch.kernels.fusion_map.ops import fusion_map  # noqa: F401
from repro_torch.kernels.fusion_map.ref import fusion_map_ref  # noqa: F401
