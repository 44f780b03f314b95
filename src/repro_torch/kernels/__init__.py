"""Hand-written Hopper kernels of the port, each beside its plain torch version."""
from repro_torch.kernels.bayes_decide import bayes_decide, bayes_decide_packed  # noqa: F401
from repro_torch.kernels.fusion_map import fusion_map  # noqa: F401
from repro_torch.kernels.node_mux import node_mux, node_mux_categorical  # noqa: F401
from repro_torch.kernels.pand_popcount import pand_popcount  # noqa: F401
from repro_torch.kernels.sne_encode import sne_encode  # noqa: F401
