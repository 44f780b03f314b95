from repro_torch.kernels.node_mux.ops import (  # noqa: F401
    node_mux,
    node_mux_categorical,
    node_mux_categorical_table,
)
from repro_torch.kernels.node_mux.ref import (  # noqa: F401
    binary_cat_table,
    cat_table,
    node_mux_cat_ref,
    node_mux_gather_ref,
    node_mux_ref,
)
