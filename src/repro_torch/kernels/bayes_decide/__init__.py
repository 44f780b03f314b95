from repro_torch.kernels.bayes_decide.ops import bayes_decide, bayes_decide_packed  # noqa: F401
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref  # noqa: F401
