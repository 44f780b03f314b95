from repro_torch.kernels.net_sweep.common import (  # noqa: F401
    SweepPlan,
    decide_counts,
    epoch_word_bounds,
    plan_from_reference,
    sweep_tile,
)
from repro_torch.kernels.net_sweep.ops import net_sweep  # noqa: F401
from repro_torch.kernels.net_sweep.program import GateProgram, record_program  # noqa: F401
from repro_torch.kernels.net_sweep.ref import net_sweep_ref  # noqa: F401
