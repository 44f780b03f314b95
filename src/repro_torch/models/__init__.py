"""Models of the port: the attention-only decoder stack and the Bayes decision head.

    layers.py       norms, RoPE, MLPs, grouped-query attention with its KV cache
    transformer.py  the decoder (attention block kinds), its module tree and
                    forward / loss / prefill / decode
    api.py          the family-dispatch facade the launchers call
    convert.py      the reference's params in and out, leaf for leaf
    bayes_head.py   the paper's fusion operators at the LM decision layer
"""
