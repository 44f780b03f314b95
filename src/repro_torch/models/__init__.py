"""Models of the port: the LM model zoo and the Bayes decision head.

    layers.py       norms, RoPE, MLPs, grouped-query attention with its KV cache
    moe.py          mixture-of-experts: sort-based capacity dispatch, dense impl
    mla.py          multi-head latent attention with its latent KV cache
    rglru.py        the RG-LRU recurrence (RecurrentGemma) and its scan
    xlstm.py        mLSTM (chunked) and sLSTM blocks
    transformer.py  the decoder (every block kind, the MTP head), its module
                    tree and forward / loss / prefill / decode
    encdec.py       the encoder-decoder model (the audio family)
    api.py          the family-dispatch facade the launchers call
    convert.py      the reference's params in and out, leaf for leaf
    bayes_head.py   the paper's fusion operators at the LM decision layer
"""
