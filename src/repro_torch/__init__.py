"""PyTorch/CUDA port of the memristor Bayesian decision system.

The JAX package ``repro`` is the reference; this package imports torch and
numpy and nothing of it.  Ported so far: the fused decision path -- scenario
specs, the ``net_sweep`` CUDA kernel for Hopper (``sm_90a``) beside its plain
torch version, ``compile_network`` and ``FrameDriver``.  Entry points take
``device=`` and default to the card.
"""
