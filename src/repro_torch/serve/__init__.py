"""Serving: the multi-tenant, fault-tolerant frame router (DESIGN.md §14).

    router.py   BayesRouter -- per-tenant FrameDrivers behind one submit /
                pump / harvest API, with deadline admission, the n_bits
                degradation ladder, backoff, a circuit breaker and the
                drift-triggered calibrate-back swap
"""

from repro_torch.serve.router import (  # noqa: F401
    BayesRouter,
    RouterPolicy,
    RouterResult,
    tenant_salt,
)
