"""The port's CUDA kernel and its main path on the card (``cuda`` marker).

Needs an NVIDIA GPU with ``nvcc``; every test skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor the
reference package, so it runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

The CUDA kernel is held bit for bit against its plain torch version, which
``test_torch_net_sweep.py`` holds against the JAX reference on the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.bayesnet as T
from repro_torch.core import prng
from repro_torch.kernels.net_sweep import kernel as K
from repro_torch.kernels.net_sweep import net_sweep

torch.set_num_threads(1)

NAMES = sorted(T.SCENARIOS)
KD = np.array([0x9E3779B9, 0x12345678], np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _evidence(spec, b, seed):
    r = np.random.default_rng(seed)
    cols = [r.integers(0, spec.card(e), b) for e in spec.evidence]
    return np.stack(cols, 1).astype(np.int32).reshape(b, len(spec.evidence))


# (name, n_bits, batch, nominal noise, drift epochs, frame0, total_frames)
_CASES = (
    [(n, 1024, 16, False, 1, 0, None) for n in NAMES]
    + [("intersection-cat", 32, 16, False, 1, 0, None),
       ("obstacle-class", 4096, 8, False, 1, 0, None),
       ("lane-change", 4096, 300, False, 1, 0, None),      # ragged last block
       ("intersection", 1024, 16, True, 2, 0, None),
       ("intersection-cat", 1024, 16, True, 3, 0, None),
       ("lane-change", 2048, 8, True, 3, 0, None),
       ("intersection", 1024, 16, False, 1, 2**25 - 7, 2**25 + 9),
       ("obstacle-class", 1024, 8, True, 2, 2**27 + 5, 2**28)]
)
_IDS = [f"{c[0]}-{c[1]}b-B{c[2]}-{'noise' if c[3] else 'clean'}-E{c[4]}-f{c[5]}"
        for c in _CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("decide", [False, True])
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_cuda_kernel_equals_plain_version(case, decide, cuda_device):
    name, n_bits, b, noisy, epochs, frame0, total = case
    spec = T.by_name(name)
    plan = T.sweep_plan(spec, spec.queries, spec.evidence,
                        noise=T.NoiseModel.nominal() if noisy else None,
                        drift_epochs=epochs)
    ev = torch.from_numpy(_evidence(spec, b, seed=1)).to(cuda_device)
    before = K.net_sweep_cuda.launches
    got = net_sweep(KD, ev, plan=plan, n_bits=n_bits, frame0=frame0,
                    total_frames=total, decide=decide)
    torch.cuda.synchronize()
    assert K.net_sweep_cuda.launches == before + 1
    want = net_sweep(KD, ev.cpu(), plan=plan, n_bits=n_bits, frame0=frame0,
                     total_frames=total, decide=decide)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["intersection-cat", "sensor-degradation"])
def test_cuda_driver_equals_cpu_driver(name, cuda_device):
    spec = T.by_name(name)
    frames = _evidence(spec, 37, seed=2)

    def serve(device):
        net = T.compile_network(spec, n_bits=512, device=device)
        sync = T.FrameDriver(net, max_batch=16, salt=9)
        sync.submit(frames)
        asyn = T.FrameDriver(net, max_batch=16, salt=9)
        asyn.submit(frames)
        decided = [t.cpu() for t in net.decide(prng.PRNGKey(4), frames)]
        return sync.drain(), asyn.drain_async(), decided

    cuda_sync, cuda_async, cuda_decided = serve(cuda_device)
    cpu_sync, _, cpu_decided = serve("cpu")
    for out in (cuda_sync, cuda_async):
        assert sorted(out) == sorted(cpu_sync)
        for rid, (post, acc) in cpu_sync.items():
            np.testing.assert_array_equal(out[rid][0], post)
            assert out[rid][1] == acc
    for g, w in zip(cuda_decided, cpu_decided):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda_device):
    spec = T.by_name("lane-change")
    plan = T.sweep_plan(spec, spec.queries, spec.evidence)
    ev = torch.zeros((4, len(spec.evidence)), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        K.net_sweep_cuda(1, 2, ev.to(torch.int64), plan=plan, n_bits=128)
    with pytest.raises(ValueError):
        K.net_sweep_cuda(1, 2, ev, plan=plan, n_bits=100)
    with pytest.raises(ValueError):
        K.net_sweep_cuda(1, 2, ev.cpu(), plan=plan, n_bits=128)
