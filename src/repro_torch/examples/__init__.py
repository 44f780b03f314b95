"""The paper's four example flows on the port, each ``run(device="cuda", **sizes) -> dict``.

    quickstart       SNE, probabilistic AND, CORDIV, the inference and fusion
                     operators, the latency model
    route_planning   Fig 3's cut-in decision as a two-node network through
                     ``FrameDriver``, the latency argument, the correlation audit
    scene_graph      Fig S8 motifs and scenario networks through the compiler,
                     the enumeration oracle, streaming frames, a k-ary node
    obstacle_fusion  Fig 4: RGB + thermal fusion of a night scene through
                     ``fusion_map`` and the stochastic ``bayes_decide``

and the LM examples: ``serve_lm`` (batched requests behind the Bayes gate)
and ``train_lm`` (a qwen2-family model trained through ``TrainLoop``).

``python -m repro_torch.examples.<name>`` runs one at the reference script's
sizes on the card and prints what the reference script prints.
"""
