"""The port's training data pipeline (``repro_torch.data.pipeline``) against
the live reference, on the CPU.

Tolerances: ``tokens`` and ``labels`` bit for bit (host Threefry ``randint``,
int32); ``extra_embeds`` (``prng.normal`` times 0.02) within NORMAL_ULP ulp
of ``jax.random.normal``'s (the platforms' ``log1p``; the bound
``test_torch_core_entropy.py`` holds ``prng.normal`` to).
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro_torch.data import DataConfig, Prefetcher, batch_at_step, pipeline

NORMAL_ULP = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _jcfg(cfg):
    return jpipeline.DataConfig(**vars(cfg))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (1, 7), (7, 3), (3, 1000), (2**31 - 1, 5)])
@pytest.mark.parametrize("shape", [(8, 128, 512), (4, 32, 32_064), (3, 17, 5)])
def test_batch_at_step_tokens_bit_equal(seed, step, shape):
    b, s, vocab = shape
    cfg = DataConfig(seed=seed, global_batch=b, seq_len=s, vocab_size=vocab)
    want = jpipeline.batch_at_step(_jcfg(cfg), step)
    got = batch_at_step(cfg, step, device="cpu")
    assert set(got) == {"tokens", "labels"}
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("frontend,n_extra", [("patch", 4), ("frame", 8)])
@pytest.mark.parametrize("step", [0, 5])
def test_batch_at_step_extra_embeds(frontend, n_extra, step):
    cfg = DataConfig(seed=2, global_batch=4, seq_len=32, vocab_size=256, frontend=frontend,
                     n_extra=n_extra, d_model=48)
    want = jpipeline.batch_at_step(_jcfg(cfg), step)
    got = batch_at_step(cfg, step, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    e = got["extra_embeds"]
    assert e.dtype == torch.float32 and tuple(e.shape) == (4, n_extra, 48)
    assert _ulps(e.numpy(), np.asarray(want["extra_embeds"])) <= NORMAL_ULP


def test_no_extra_embeds_without_a_size():
    for kw in (dict(frontend="patch", n_extra=0, d_model=8), dict(frontend="frame", n_extra=4),
               dict(frontend="none", n_extra=4, d_model=8)):
        assert "extra_embeds" not in batch_at_step(DataConfig(**kw), 0, device="cpu")


def test_batch_at_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_at_step(DataConfig(), 0)


def test_data_pipeline_determinism_and_host_slicing():
    """tests/train/test_train_loop.py's test, on the port."""
    dc = DataConfig(seed=7, global_batch=8, seq_len=16, vocab_size=128)
    b1 = batch_at_step(dc, 3, device="cpu")
    b2 = batch_at_step(dc, 3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = batch_at_step(dc, 4, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    s0 = pipeline.host_slice(b1, 0, 2)["tokens"]
    s1 = pipeline.host_slice(b1, 1, 2)["tokens"]
    assert torch.equal(torch.cat([s0, s1]), b1["tokens"])
    want = jpipeline.host_slice(jpipeline.batch_at_step(_jcfg(dc), 3), 1, 4)
    got = pipeline.host_slice(b1, 1, 4)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefetcher():
    """tests/train/test_train_loop.py's test, on the port: host batches (numpy),
    in order, equal to the reference's."""
    dc = DataConfig(seed=0, global_batch=2, seq_len=8, vocab_size=64)
    pf = Prefetcher(dc, start_step=0, depth=2)
    try:
        step, batch = next(pf)
        assert step == 0 and batch["tokens"].shape == (2, 8)
        assert isinstance(batch["tokens"], np.ndarray)
        step, batch = next(pf)
        assert step == 1
        want = jpipeline.batch_at_step(_jcfg(dc), 1)
        np.testing.assert_array_equal(batch["labels"], np.asarray(want["labels"]))
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_resumes_at_its_start_step():
    dc = DataConfig(seed=4, global_batch=2, seq_len=8, vocab_size=64)
    pf = Prefetcher(dc, start_step=11, depth=1)
    try:
        got = [next(pf) for _ in range(3)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [11, 12, 13]
    for s, batch in got:
        np.testing.assert_array_equal(
            batch["tokens"], np.asarray(jpipeline.batch_at_step(_jcfg(dc), s)["tokens"]))
    assert jax.numpy.asarray(got[0][1]["tokens"]).dtype == jax.numpy.int32
