"""The port's enumeration oracle against the JAX reference, on the CPU.

``joint_table``'s assignment grid is equal to the reference's and its joint
bit for bit (the same float32 products in the same order).  Posteriors and
evidence marginals are float32 sums taken in another order than the
reference's, so they are held within ``POST_ATOL = 5e-7`` (a few ulps at
1.0; the largest difference seen on the grid below is 3.6e-7) and
``P_E_RTOL = 2e-6``.  Evidence frames are drawn by the reference's sampler and
fed to both.  The port's sampler draws from a ``torch.Generator`` and cannot
reproduce ``jax.random``'s bits, so it is held by distribution: every
node's marginal over 2**16 draws within 4.5 sigma of the joint's.

Last, the random k-ary DAG ``kary7060`` on which the reference's
``test_unfused_kary_dags_match_enumeration_oracle`` fails at hypothesis seed
7060, rebuilt here for both packages.
"""

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.bayesnet import analytic as RA
import repro_torch.bayesnet as T
from repro_torch.bayesnet import analytic as TA
from repro_torch.bayesnet import compile as tcompile
from repro_torch.core import bitops, prng

torch.set_num_threads(1)

NAMES = sorted(R.SCENARIOS)
POST_ATOL, P_E_RTOL = 5e-7, 2e-6
# oracle configurations: keywords, with "nominal" filled in per package
CONFIGS = {
    "plain": dict(),
    "dac": dict(dac_quantize=True),
    "noise": dict(noise="nominal"),
    "epochs": dict(noise="nominal", drift_epochs=3, n_bits=4096),
    "epochs_uniform": dict(noise="nominal", drift_epochs=2),
    "program": dict(noise="nominal", program=True),
}


def _kwargs(name, config, pkg):
    kw = dict(CONFIGS[config])
    if "noise" in kw:
        kw["noise"] = pkg.NoiseModel.nominal()
    if "program" in kw:
        spec = T.by_name(name)
        clean = T.perturbed_cdf_rows(spec, None)
        kw["program"] = {n: tuple(tuple(min(256, t + 2) for t in row) for row in clean[n])
                         for n in spec.topo_order()[-2:]}
    return kw


def _reference_evidence(name, batch=128, seed=3):
    return np.array(RA.sample_evidence(R.by_name(name), jax.random.PRNGKey(seed), batch))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", NAMES)
def test_posterior_matches_reference(name, config):
    rspec, tspec = R.by_name(name), T.by_name(name)
    rstates, rjoint = RA.joint_table(rspec, **_kwargs(name, config, R))
    tstates, tjoint = TA.joint_table(tspec, device="cpu", **_kwargs(name, config, T))
    np.testing.assert_array_equal(tstates.numpy(), np.asarray(rstates))
    np.testing.assert_array_equal(tjoint.numpy(), np.asarray(rjoint))
    ev = _reference_evidence(name)
    ev[0] = 0                                  # a frame of all-zero evidence
    rpost, rpe = RA.make_posterior_fn(rspec, **_kwargs(name, config, R))(ev)
    tpost, tpe = TA.make_posterior_fn(tspec, device="cpu", **_kwargs(name, config, T))(ev)
    assert tpost.shape == rpost.shape and tpost.dtype == torch.float32
    np.testing.assert_allclose(tpost.numpy(), np.asarray(rpost), rtol=0, atol=POST_ATOL)
    np.testing.assert_allclose(tpe.numpy(), np.asarray(rpe), rtol=P_E_RTOL, atol=0)


def test_impossible_evidence_falls_back_like_reference():
    from repro.bayesnet.spec import NetworkSpec as RSpec, Node as RNode
    from repro_torch.bayesnet.spec import NetworkSpec as TSpec, Node as TNode

    def spec(Spec, Node):
        return Spec(name="impossible", nodes=(
            Node("a", (), ((0.0, 1.0, 0.0),), k=3),
            Node("b", ("a",), ((1.0, 0.0), (1.0, 0.0), (0.5, 0.5))),
            Node("c", ("a",), ((0.9, 0.1), (0.2, 0.8), (0.5, 0.5)))),
            evidence=("b",), queries=("a", "c"))
    ev = np.array([[0], [1]], np.int32)         # b = 1 is impossible
    rpost, rpe = RA.make_posterior_fn(spec(RSpec, RNode))(ev)
    tpost, tpe = TA.make_posterior_fn(spec(TSpec, TNode), device="cpu")(ev)
    np.testing.assert_allclose(tpost.numpy(), np.asarray(rpost), rtol=0, atol=POST_ATOL)
    np.testing.assert_array_equal(tpe.numpy(), np.asarray(rpe))
    assert float(tpe[1]) == 0.0


def test_oracle_validates_and_defaults_to_the_card():
    spec = T.by_name("lane-change")
    with pytest.raises(ValueError):
        TA.joint_table(spec, drift_epochs=2, device="cpu")
    with pytest.raises(ValueError):
        TA.make_posterior_fn(spec, device="cpu")(np.zeros((2, 1), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TA.make_posterior_fn(spec)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_marginals_match_the_joint(name):
    spec = T.by_name(name)
    n = 1 << 16
    draws = TA._sample_joint(spec, prng.PRNGKey(7), n, "cpu").numpy()
    states, joint = TA.joint_table(spec, device="cpu")
    states, joint = states.numpy(), joint.numpy().astype(np.float64)
    for j, node in enumerate(spec.nodes):
        for v in range(spec.card(node.name)):
            p = float(joint[states[:, j] == v].sum())
            got = float((draws[:, j] == v).mean())
            sigma = np.sqrt(max(p * (1 - p), 1e-12) / n)
            assert abs(got - p) <= 4.5 * sigma + 1e-12, (name, node.name, v, got, p)
    ev = TA.sample_evidence(spec, prng.PRNGKey(7), n, device="cpu")
    assert ev.dtype == torch.int32 and tuple(ev.shape) == (n, len(spec.evidence))
    np.testing.assert_array_equal(ev.numpy(), draws[:, [spec.index(e) for e in spec.evidence]])
    # the reference's frames from the same key, value for value
    want = RA.sample_evidence(R.by_name(name), jax.random.PRNGKey(7), n)
    np.testing.assert_array_equal(ev.numpy(), np.asarray(want))


# --- the reference's fill path at hypothesis seed 7060 -------------------------------


def _random_kary_dag(seed, Spec, Node):
    """tests/bayesnet/test_categorical.py::_random_kary_dag, for either package."""
    rs = np.random.RandomState(seed)
    n = int(rs.randint(4, 8))
    nodes, cards = [], []
    for i in range(n):
        k = int(rs.randint(2, 6))
        m = int(min(i, rs.randint(0, 4)))
        pidx = sorted(rs.choice(i, size=m, replace=False)) if m else []
        n_rows = int(np.prod([cards[j] for j in pidx])) if pidx else 1
        rows = []
        for _ in range(n_rows):
            cuts = np.sort(rs.choice(np.arange(8, 249), size=k - 1, replace=False))[::-1]
            bounds = np.concatenate([[256], cuts, [0]])
            rows.append(tuple((bounds[:-1] - bounds[1:]) / 256.0))
        nodes.append(Node(f"n{i}", tuple(f"n{j}" for j in pidx), tuple(rows), k=k))
        cards.append(k)
    names = [nd.name for nd in nodes]
    n_ev = int(rs.randint(1, 3))
    ev = tuple(str(e) for e in rs.choice(names[1:], size=min(n_ev, n - 1), replace=False))
    queries = tuple(nm for nm in names if nm not in ev)[:2]
    return Spec(name=f"kary{seed}", nodes=tuple(nodes), evidence=ev, queries=queries)


def _fill_sigma(accept_words, exact, n_bits):
    """The fill estimator's standard error for one realised acceptance stream.

    The quotient stream holds each accepted sample for the gap G_j to the
    next accepted position (or to the end), so given the stream the estimate
    is sum_j x_j G_j / n_bits with variance p (1 - p) sum_j G_j**2 / n_bits**2.
    """
    bits = bitops.unpack_bits(accept_words, n_bits).numpy()          # (B, n_bits)
    sig = []
    for row in bits:
        pos = np.flatnonzero(row)
        gaps = np.diff(np.append(pos, n_bits)).astype(np.float64)
        sig.append(np.sqrt((gaps**2).sum()) / n_bits)
    return np.sqrt(np.clip(exact * (1 - exact), 1e-3, None)) * np.asarray(sig)[:, None, None]


def test_kary7060_fill_is_the_reference_path_and_within_its_own_variance():
    from repro.bayesnet.spec import NetworkSpec as RSpec, Node as RNode
    from repro_torch.bayesnet.spec import NetworkSpec as TSpec, Node as TNode

    n_bits, seed = 1 << 14, 7060
    rspec, tspec = _random_kary_dag(seed, RSpec, RNode), _random_kary_dag(seed, TSpec, TNode)
    frames = np.zeros((2, len(tspec.evidence)), np.int32)
    exact = TA.make_posterior_fn(tspec, device="cpu")(frames)[0].numpy()
    rexact = np.asarray(R.make_posterior_fn(rspec)(frames)[0])
    np.testing.assert_allclose(exact, rexact, rtol=0, atol=POST_ATOL)
    out = {}
    for est in ("fill", "ratio"):
        rnet = R.compile_network(rspec, n_bits=n_bits, estimator=est, fused=False)
        tnet = T.compile_network(tspec, n_bits=n_bits, estimator=est, fused=False,
                                 device="cpu")
        rpost, racc = rnet.run(jax.random.PRNGKey(seed), frames)
        tpost, tacc = tnet.run(prng.PRNGKey(seed), frames)
        np.testing.assert_array_equal(tpost.numpy(), np.asarray(rpost))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(racc))
        out[est] = (tpost.numpy(), tacc.numpy())
    # the reference test's bound: binomial sigma on the accepted count
    binom = np.sqrt(np.clip(exact * (1 - exact), 1e-3, None) / out["fill"][1][:, None, None])
    z_fill_binom = np.abs(out["fill"][0] - exact) / binom
    z_ratio = np.abs(out["ratio"][0] - exact) / binom
    assert z_fill_binom.max() > 4.5          # what the reference test reports
    assert z_ratio.max() < 4.5               # the same streams, counted by the ratio
    streams = tcompile.lower_streams(tspec, prng.PRNGKey(seed), n_bits, batch=2,
                                     device="cpu")
    accept = tcompile._acceptance(torch.from_numpy(frames),
                                  tuple(streams[e] for e in tspec.evidence), n_bits)
    z_fill = np.abs(out["fill"][0] - exact) / _fill_sigma(accept, exact, n_bits)
    assert z_fill.max() < 4.5                # within the fill estimator's own spread
