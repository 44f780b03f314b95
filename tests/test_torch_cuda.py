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
from torch_wide_net import wide_spec

torch.set_num_threads(1)

NAMES = sorted(T.SCENARIOS)
KD = np.array([0x9E3779B9, 0x12345678], np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _spec(name):
    return wide_spec(T, int(name[5:])) if name.startswith("wide-") else T.by_name(name)


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
       ("obstacle-class", 1024, 8, True, 2, 2**27 + 5, 2**28),
       ("wide-7", 4096, 300, False, 1, 0, None),
       ("wide-7", 1024, 16, True, 3, 2**26 - 3, 2**26 + 13)]
)
_IDS = [f"{c[0]}-{c[1]}b-B{c[2]}-{'noise' if c[3] else 'clean'}-E{c[4]}-f{c[5]}"
        for c in _CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("decide", [False, True])
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_cuda_kernel_equals_plain_version(case, decide, cuda_device):
    name, n_bits, b, noisy, epochs, frame0, total = case
    spec = _spec(name)
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


@pytest.mark.cuda
def test_compile_network_builds_before_the_first_launch(cuda_device):
    """compile_network(device="cuda") builds the plan's kernel, so a drain
    never waits on nvcc; plans with identical programs share a library."""
    spec = T.by_name("pedestrian-night")
    noise = T.NoiseModel.nominal(seed=7919)        # a plan no other test builds
    builds = K.net_sweep_cuda.builds
    net = T.compile_network(spec, n_bits=512, device=cuda_device, noise=noise)
    assert K.net_sweep_cuda.builds == builds + 1      # a new plan: its own program
    launches = K.net_sweep_cuda.launches
    driver = T.FrameDriver(net, max_batch=16, salt=3)
    driver.submit(_evidence(spec, 40, seed=4))
    assert len(driver.drain_async()) == 40
    torch.cuda.synchronize()
    assert K.net_sweep_cuda.builds == builds + 1
    assert K.net_sweep_cuda.launches > launches
    # the same plan at another n_bits draws no word-dependent literal: no build
    T.compile_network(spec, n_bits=1024, device=cuda_device, noise=noise)
    assert K.net_sweep_cuda.builds == builds + 1


@pytest.mark.cuda
def test_retry_escalation_with_drift_epochs_builds_nothing(cuda_device):
    """A drift-epoch plan's program takes the word count at run time, so the
    retry levels' longer streams reuse the library compile_network built."""
    spec = T.by_name("lane-change")
    noise = T.NoiseModel.nominal(seed=7927)        # a plan no other test builds
    retry = T.RetryPolicy(min_confidence=0.95, max_retries=2, escalation=2)
    frames = _evidence(spec, 40, seed=5)
    outs = []
    for device in (cuda_device, "cpu"):
        net = T.compile_network(spec, n_bits=512, device=device, noise=noise,
                                drift_epochs=3)
        builds, launches = K.net_sweep_cuda.builds, K.net_sweep_cuda.launches
        driver = T.FrameDriver(net, max_batch=16, salt=5, retry=retry)
        driver.submit(frames)
        outs.append(driver.drain())
        assert K.net_sweep_cuda.builds == builds
        if device != "cpu":
            torch.cuda.synchronize()
            assert K.net_sweep_cuda.launches > launches
            assert any(r.attempts > 1 for r in driver.reports.values())
    assert sorted(outs[0]) == sorted(outs[1])
    for rid, (post, acc) in outs[1].items():
        np.testing.assert_array_equal(outs[0][rid][0], post)
        assert outs[0][rid][1] == acc


@pytest.mark.cuda
def test_swap_net_with_two_launches_pending_on_the_card(cuda_device):
    """swap_net while both of a driver's launches are still pending on the
    device (queued behind a device-side delay): no frame lost, the pre-swap
    frames equal a never-swapped twin's, no program built in the drains, and
    the whole output equal to the same run on the CPU."""
    spec = T.by_name("pedestrian-night")
    noise = T.NoiseModel(seed=4, cycle=4, wear_tau=4.0)
    frames = _evidence(spec, 16, seed=6)

    def serve(device, delay=0):
        net = T.compile_network(spec, 1024, noise=noise, drift_epochs=2, device=device)
        recal = T.recalibrated_network(net, cycle=8)     # its program is built here
        twin = T.FrameDriver(net, max_batch=4, salt=99)
        swapped = T.FrameDriver(net, max_batch=4, salt=99)
        t_rids, s_rids = twin.submit(frames), swapped.submit(frames)
        builds = K.net_sweep_cuda.builds
        pending = []
        if delay:
            for _ in range(4):                # cached pinned and device blocks for the launches
                net.run(prng.PRNGKey(0), frames[:4])
            torch.cuda.synchronize()
            torch.cuda._sleep(delay)
        for drv in (twin, swapped):
            drv.step(block=False)
            drv.step(block=False)
        if delay:
            pending = [not lf.done.query() for lf in swapped._inflight]
        swapped.swap_net(recal)
        out_twin, out_swapped = twin.drain(), swapped.drain()
        assert K.net_sweep_cuda.builds == builds
        assert sorted(out_swapped) == s_rids                     # lost 0
        for t, s in zip(t_rids[:8], s_rids[:8]):
            np.testing.assert_array_equal(out_twin[t][0], out_swapped[s][0])
            assert out_twin[t][1] == out_swapped[s][1]
        return out_swapped, pending

    card, pending = serve(cuda_device, delay=1 << 30)
    assert pending == [True, True]
    cpu, _ = serve("cpu")
    assert sorted(card) == sorted(cpu)
    for rid, (post, acc) in cpu.items():
        np.testing.assert_array_equal(card[rid][0], post)
        assert card[rid][1] == acc
