"""Serving: the LM engine and the multi-tenant, fault-tolerant frame router.

    engine.py   ServeEngine -- batched prefill/decode on the KV cache,
                continuous batching and the Bayes-gated emission

    router.py   BayesRouter -- per-tenant FrameDrivers behind one submit /
                pump / harvest API, with deadline admission, the n_bits
                degradation ladder, backoff, a circuit breaker and the
                drift-triggered calibrate-back swap
"""

from repro_torch.serve.engine import EngineConfig, Request, ServeEngine  # noqa: F401
from repro_torch.serve.router import (  # noqa: F401
    BayesRouter,
    RouterPolicy,
    RouterResult,
    tenant_salt,
)
