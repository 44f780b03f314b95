"""Exact enumeration oracle for :class:`~repro_torch.bayesnet.spec.NetworkSpec`.

Full-joint enumeration over the ``prod(k_i)`` mixed-radix assignments: the
assignment grid, the per-node CPT gathers and the evidence masks are plain
tensor ops, so one call evaluates a batch of evidence frames against the
whole joint.  It is the correctness bound of the stochastic programs:
compiled posteriors must match it within O(1/sqrt(accepted)).

``dac_quantize=True`` snaps every CPT row to the distribution the 8-bit DAC
CDF samples (``rng.cdf_thresholds_int`` differenced back into per-value
probabilities).  ``noise=`` / ``program=`` enumerate the perturbed network
that ``compile_network(noise=..., program=...)`` samples, and
``drift_epochs`` the word-weighted mixture of the per-epoch perturbed joints
that the epoched fused sweep converges to.

Posterior layout mirrors the compiler: all-binary query sets give ``(B, n_q)``
of ``P(q=1)``; any k-ary query gives ``(B, n_q, max_k)`` normalised
per-value posteriors (zero-padded, uniform over the query's values where the
evidence is impossible; 0.5 in the binary layout).

Sums run in float32 in another order than the reference's, so posteriors
agree with it within a few float32 ulps, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bayesnet.noise import NoiseModel, perturbed_cdf_rows
from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import prng, rng
from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep.common import epoch_word_bounds

_MAX_STATES = 1 << 20


def _node_rows(spec: NetworkSpec, name: str, dac_quantize: bool,
               perturbed=None) -> np.ndarray:
    """(L, k) float32 CPT rows, optionally DAC-snapped or perturbed.

    ``perturbed`` (name -> integer CDF rows from :func:`perturbed_cdf_rows`)
    takes precedence: its thresholds are differenced back to per-value
    probabilities, the distribution the noisy program samples.
    """
    rows = spec.cpt_rows(name)
    if perturbed is not None:
        cdfs = perturbed[name]
    elif dac_quantize:
        cdfs = tuple(rng.cdf_thresholds_int(row) for row in rows)
    else:
        return np.asarray(rows, np.float32)
    snapped = []
    for cdf in cdfs:
        bounds = (256,) + tuple(cdf) + (0,)
        snapped.append(tuple((bounds[v] - bounds[v + 1]) / 256.0 for v in range(len(cdf) + 1)))
    return np.asarray(snapped, np.float32)


def joint_table(
    spec: NetworkSpec,
    dac_quantize: bool = False,
    noise: NoiseModel | None = None,
    *,
    drift_epochs: int = 1,
    program: dict | None = None,
    n_bits: int | None = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (states (S, N) int32, joint (S,) float32), S = prod(cards).

    Column ``j`` of ``states`` is the value of ``spec.nodes[j]`` (node 0 the
    fastest-cycling mixed-radix digit); ``joint`` the probability of each
    assignment.  ``drift_epochs=E > 1`` gives the mixture ``sum_e w_e *
    joint_e`` of the per-epoch perturbed joints (epoch ``e`` at
    ``noise.with_cycle(noise.cycle + e)``), ``w_e`` each epoch's share of the
    packed words when ``n_bits`` is given and uniform otherwise.
    """
    dev = backend.resolve_device(device)
    drift_epochs = int(drift_epochs)
    if drift_epochs > 1 and noise is None:
        raise ValueError("drift_epochs > 1 needs a NoiseModel to advance")
    cards = spec.cards()
    total = math.prod(cards)
    if total > _MAX_STATES:
        raise ValueError(f"enumeration oracle capped at {_MAX_STATES} joint states, got {total}")
    idx = {node.name: j for j, node in enumerate(spec.nodes)}
    s = np.arange(total, dtype=np.int64)
    cols = []
    for c in cards:
        cols.append((s % c).astype(np.int32))
        s //= c
    states = torch.from_numpy(np.stack(cols, axis=-1)).to(dev)
    long_states = states.to(torch.int64)

    def one_epoch_joint(perturbed):
        joint = torch.ones((total,), dtype=torch.float32, device=dev)
        for node in spec.nodes:
            cpt = torch.from_numpy(_node_rows(spec, node.name, dac_quantize, perturbed)).to(dev)
            # mixed-radix CPT row index: first parent = most significant digit
            row = torch.zeros((total,), dtype=torch.int64, device=dev)
            for parent in node.parents:
                row = row * spec.card(parent) + long_states[:, idx[parent]]
            joint = joint * cpt[row, long_states[:, idx[node.name]]]
        return joint

    if noise is None and program is None:
        return states, one_epoch_joint(None)
    if drift_epochs == 1:
        return states, one_epoch_joint(perturbed_cdf_rows(spec, noise, program=program))
    if n_bits is not None:
        spans = np.diff(epoch_word_bounds(n_bits // 32, drift_epochs)).astype(np.float64)
        weights = spans / max(spans.sum(), 1.0)
    else:
        weights = np.full((drift_epochs,), 1.0 / drift_epochs)
    joint = torch.zeros((total,), dtype=torch.float32, device=dev)
    for e, w_e in enumerate(weights):
        pe = perturbed_cdf_rows(spec, noise.with_cycle(noise.cycle + e), program=program)
        joint = joint + float(np.float32(w_e)) * one_epoch_joint(pe)
    return states, joint


def make_posterior_fn(
    spec: NetworkSpec,
    queries: Sequence[str] | None = None,
    evidence: Sequence[str] | None = None,
    dac_quantize: bool = False,
    noise: NoiseModel | None = None,
    *,
    drift_epochs: int = 1,
    program: dict | None = None,
    n_bits: int | None = None,
    device="cuda",
) -> Callable:
    """The exact batched posterior of a spec.

    Returns ``fn(ev_frames (B, n_ev) int) -> (post, p_evidence (B,))`` with
    the layout of the module docstring, on ``device``.  Columns of the
    frames follow ``evidence`` and hold one value in ``[0, card)`` each;
    ``p_evidence`` is the evidence marginal (0 where impossible).
    ``noise`` / ``drift_epochs`` / ``program`` / ``n_bits`` give the oracle
    twin of the matching compiled program (see :func:`joint_table`).
    """
    dev = backend.resolve_device(device)
    queries = tuple(queries if queries is not None else spec.queries)
    evidence = tuple(evidence if evidence is not None else spec.evidence)
    states, joint = joint_table(spec, dac_quantize=dac_quantize, noise=noise,
                                drift_epochs=drift_epochs, program=program,
                                n_bits=n_bits, device=dev)
    ev_states = states[:, [spec.index(e) for e in evidence]]           # (S, n_ev)
    q_states = states[:, [spec.index(q) for q in queries]]             # (S, n_q)
    q_cards = tuple(spec.card(q) for q in queries)
    kmax = max(q_cards) if q_cards else 2
    values = torch.arange(kmax, dtype=torch.int32, device=dev)

    def posterior(ev_frames) -> Tuple[torch.Tensor, torch.Tensor]:
        if not isinstance(ev_frames, torch.Tensor):
            ev_frames = torch.from_numpy(np.asarray(ev_frames, np.int32))
        ev = ev_frames.to(device=dev, dtype=torch.int32)
        if ev.dim() != 2 or ev.shape[1] != len(evidence):
            raise ValueError(f"evidence frames must be (B, {len(evidence)}), "
                             f"got {tuple(ev.shape)}")
        match = (ev_states[None, :, :] == ev[:, None, :]).all(dim=-1)  # (B, S)
        w = match.to(torch.float32) * joint[None, :]
        p_e = w.sum(dim=-1)
        safe = torch.clamp(p_e, min=1e-30)[:, None]
        if all(c == 2 for c in q_cards):
            num = (w[:, :, None] * q_states[None].to(torch.float32)).sum(dim=1)
            post = torch.where(p_e[:, None] > 0, num / safe,
                               torch.full_like(num, 0.5))
            return post, p_e
        posts = []
        for qi, c in enumerate(q_cards):
            onehot = (q_states[:, qi, None] == values).to(torch.float32)   # (S, kmax)
            num = (w[:, :, None] * onehot[None]).sum(dim=1)                # (B, kmax)
            fallback = torch.tensor([1.0 / c if v < c else 0.0 for v in range(kmax)],
                                    dtype=torch.float32, device=dev)
            posts.append(torch.where(p_e[:, None] > 0, num / safe,
                                     fallback.expand_as(num)))
        return torch.stack(posts, dim=1), p_e

    return posterior


def _sample_joint(spec: NetworkSpec, key, batch: int, device) -> torch.Tensor:
    """Ancestral sampling: (B, N) int32 values in declared node order.

    Each node, in topological order, takes the next split of ``key``, draws
    ``batch`` uniforms under it on ``device``
    (:func:`~repro_torch.core.prng.device_uniform`, the reference's draws bit
    for bit) and takes value ``#{v : u < P(value >= v | parents)}``.
    """
    dev = backend.resolve_device(device)
    idx = {node.name: j for j, node in enumerate(spec.nodes)}
    vals = [None] * spec.n_nodes
    for name in spec.topo_order():
        node = spec.node(name)
        key, sub = prng.split(key)
        rows = np.asarray(spec.cpt_rows(name), np.float32)
        tails = torch.from_numpy(np.cumsum(rows[:, ::-1], axis=-1)[:, ::-1][:, 1:].copy()).to(dev)
        row = torch.zeros((batch,), dtype=torch.int64, device=dev)
        for parent in node.parents:
            row = row * spec.card(parent) + vals[idx[parent]]
        u = prng.device_uniform(sub, (batch,), device=dev)
        vals[idx[name]] = (u[:, None] < tails[row]).sum(dim=-1)
    return torch.stack(vals, dim=-1).to(torch.int32)


def sample_evidence(spec: NetworkSpec, key, batch: int,
                    evidence: Sequence[str] | None = None, *, device="cuda") -> torch.Tensor:
    """Draw (B, n_ev) int32 evidence frames by ancestral joint sampling.

    Frames are distributed as the network predicts its sensors to fire, and
    equal the reference's for the same key; they lie on ``device``.
    """
    evidence = tuple(evidence if evidence is not None else spec.evidence)
    full = _sample_joint(spec, key, batch, device)
    return full[:, [spec.index(e) for e in evidence]]
