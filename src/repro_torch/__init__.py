"""PyTorch/CUDA port of the memristor Bayesian decision system.

The JAX package ``repro`` is the reference; this package imports torch and
numpy and nothing of it.  Ported so far: the whole decision path -- scenario
specs, ``compile_network`` (fused on the per-plan ``net_sweep`` CUDA kernel for
Hopper, ``sm_90a``, or unfused on the ``sne_encode`` / ``node_mux`` kernels),
``FrameDriver``, the calibrate-back loop and the multi-tenant ``BayesRouter``
(``repro_torch.serve``) -- the paper's fusion operators and the enumeration
oracle, each CUDA kernel beside its plain torch version; and the
paper-figure layer (``repro_torch.core``: device model, SNEs, probabilistic
logic, correlation, inference, the Fig S8 motifs, stochastic fusion, the
latency model) with the four paper examples (``repro_torch.examples``); and
the LM serving path -- the configs of every arch, the attention-only decoder
stack (``repro_torch.models``), the ``ServeEngine`` whose Bayes gate runs the
``bayes_decide`` kernel, its launcher and the ``serve_lm`` example; every
block kind of the model zoo; and the training stack -- AdamW
(``repro_torch.optim``), the data pipeline, checkpoints in the reference's
on-disk form (``repro_torch.checkpoint``), ``TrainLoop``
(``repro_torch.train``), the train launcher and the ``train_lm`` example.
Entry points take ``device=`` and default to the card.
"""
