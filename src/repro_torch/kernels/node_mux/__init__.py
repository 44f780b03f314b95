from repro_torch.kernels.node_mux.ops import node_mux, node_mux_categorical  # noqa: F401
from repro_torch.kernels.node_mux.ref import (  # noqa: F401
    node_mux_cat_ref,
    node_mux_gather_ref,
    node_mux_ref,
)
