"""Compile a :class:`~repro_torch.bayesnet.spec.NetworkSpec` to one fused launch.

The port carries the reference's **fused** lowering: the whole network --
per-node categorical threshold-gather sampling, the evidence AND, the CORDIV
popcount fixed point -- is ONE :func:`~repro_torch.kernels.net_sweep.net_sweep`
launch.  Entropy is generated in the kernel from counter bit-planes with the
frame index folded into the counters, so every frame draws an independent
joint sample and node streams never reach device memory.

Posterior contract (as in the reference): when every query node is binary,
``run`` returns ``(B, n_q)`` of ``P(q=1 | evidence)``; when any query has
``k > 2`` it returns ``(B, n_q, max_k)`` normalised per-value posteriors
(rows of smaller queries zero-padded).  ``decide`` returns the posterior and
the per-query MAP decisions taken in the kernel from the same counts.

``device=`` names where the program runs and defaults to the card; asking for
CUDA where there is none raises.  The unfused lowering (``fused=False``,
``share_entropy=True``, ``estimator='fill'``, ``mux_mode='rows'``) and
multi-device launches are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bayesnet.noise import NoiseModel, perturbed_cdf_rows
from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import cordiv, rng
from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep import SweepPlan, net_sweep
from repro_torch.obs import Tracer

_UNFUSED_TODO = "ROADMAP queue 1 item 11 (the unfused lowering)"
_DEVICES_TODO = "ROADMAP queue 1 item 10 (multi-device launch)"


def network_stats(net: "CompiledNetwork") -> dict:
    """Static plan statistics for one compiled program (span / log fodder).

    ``n_nodes`` / ``n_edges`` (DAG shape), ``cpt_rows`` (crossbar rows),
    ``n_thresholds`` (8-bit DAC thresholds, ``rows x (card - 1)`` per node),
    ``threshold_mask_bytes`` (8 plane-mask words of 4 bytes per threshold:
    the reference's folded constant footprint), ``n_value_slots``.
    """
    spec = net.spec
    n_edges = n_rows = n_thresholds = 0
    for name in spec.topo_order():
        node = spec.node(name)
        rows = spec.cpt_rows(name)
        n_edges += len(node.parents)
        n_rows += len(rows)
        n_thresholds += len(rows) * (spec.card(name) - 1)
    return {
        "n_nodes": spec.n_nodes,
        "n_edges": n_edges,
        "cpt_rows": n_rows,
        "n_thresholds": n_thresholds,
        "threshold_mask_bytes": n_thresholds * 8 * 4,
        "n_value_slots": sum(c - 1 for c in net.query_cards),
        "n_bits": net.n_bits,
        "fused": net.fused,
        "n_shards": net.n_shards,
    }


def _posterior_from_counts(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Per-frame posteriors from count arrays: numer (B, n_s), denom (B,)."""
    return cordiv.ratio_from_counts(numer, denom[:, None])


def _count_assembler(q_cards: Tuple[int, ...]) -> Callable:
    """Counts -> posterior map (count-exact value 0).

    All-binary query sets keep the classic ``(B, n_q)`` slot layout.
    Otherwise every column is the float32 of ``count / denom``, with the
    value-0 count rebuilt in integers (``denom - sum(slots)``) -- the same
    convention :func:`~repro_torch.kernels.net_sweep.decide_counts` applies,
    so equal counts give equal floats and the posterior argmax agrees with the
    in-kernel decision on ties.  ``denom == 0`` gives the all-zero vector.
    """
    if all(c == 2 for c in q_cards):
        return _posterior_from_counts
    kmax = max(q_cards)

    def assemble(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
        cols = []
        off = 0
        for c in q_cards:
            v = numer[:, off : off + c - 1]
            off += c - 1
            c0 = denom[:, None] - v.sum(dim=-1, keepdim=True, dtype=torch.int32)
            p = cordiv.ratio_from_counts(torch.cat([c0, v], dim=-1), denom[:, None])
            if kmax > c:
                p = torch.cat([p, p.new_zeros((p.shape[0], kmax - c))], dim=-1)
            cols.append(p)
        return torch.stack(cols, dim=1)

    return assemble


def posterior_argmax(post) -> torch.Tensor:
    """MAP decision from a ``run`` posterior, matching the fused epilogue.

    Binary layout ``(B, n_q)``: value 1 wins iff ``P(q=1) > 0.5``.  k-ary
    layout ``(B, n_q, kmax)``: argmax over values, ties to the lowest value.
    """
    post = torch.as_tensor(post)
    if post.dim() == 2:
        return (post > 0.5).to(torch.int32)
    return torch.argmax(post, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class CompiledNetwork:
    """A network lowered to one fused sweep on one device.

    ``run(key, ev_frames (B, n_ev)) -> (post, accepted (B,))`` and
    ``decide(key, ev_frames) -> (post, decisions (B, n_q), accepted)``.
    ``key`` is ``(2,)`` uint32 key data (:mod:`repro_torch.core.prng`);
    results are tensors on ``device``, returned without synchronising.
    ``accepted[b]`` is the number of stream positions that satisfied frame
    ``b``'s evidence, the effective sample count.
    """

    spec: NetworkSpec
    queries: Tuple[str, ...]
    evidence: Tuple[str, ...]
    n_bits: int
    share_entropy: bool
    estimator: str
    fused: bool
    query_cards: Tuple[int, ...]
    plan: SweepPlan = dataclasses.field(repr=False)
    device: torch.device
    n_shards: int = 1
    noise: NoiseModel | None = None
    drift_epochs: int = 1
    program: dict | None = dataclasses.field(default=None, repr=False, compare=False)

    def _check_frames(self, ev_frames) -> torch.Tensor:
        if isinstance(ev_frames, torch.Tensor):
            ev = ev_frames.to(device=self.device, dtype=torch.int32)
        else:
            ev = torch.from_numpy(np.asarray(ev_frames, np.int32)).to(self.device)
        if ev.dim() != 2 or ev.shape[1] != len(self.evidence):
            raise ValueError(
                f"evidence frames must be (B, {len(self.evidence)}), got {tuple(ev.shape)}"
            )
        return ev

    def _assemble(self, numer, denom):
        return _count_assembler(self.query_cards)(numer, denom)

    def run(self, key, ev_frames) -> Tuple[torch.Tensor, torch.Tensor]:
        numer, denom = net_sweep(key, self._check_frames(ev_frames),
                                 plan=self.plan, n_bits=self.n_bits)
        return self._assemble(numer, denom), denom

    def decide(self, key, ev_frames) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Posteriors AND per-query MAP decisions in the same launch.

        The kernel argmaxes the per-query count slots itself, so the
        sense->classify->act path is one launch; the decisions equal
        :func:`posterior_argmax` of the posterior bit for bit.
        """
        numer, denom, dec = net_sweep(key, self._check_frames(ev_frames),
                                      plan=self.plan, n_bits=self.n_bits,
                                      decide=True)
        return self._assemble(numer, denom), dec, denom


def sweep_plan(
    spec: NetworkSpec,
    queries: Sequence[str],
    evidence: Sequence[str],
    noise: NoiseModel | None = None,
    *,
    drift_epochs: int = 1,
    program: dict | None = None,
) -> SweepPlan:
    """Lower a spec to the static :class:`SweepPlan` the fused kernel consumes.

    Nodes are renumbered into topological order; each CPT row becomes its
    ``card - 1`` cumulative 8-bit DAC thresholds (``rng.cdf_thresholds_int``).
    ``noise`` perturbs every threshold through the crossbar model before it
    is baked in.  ``drift_epochs=E > 1`` re-perturbs at
    ``noise.with_cycle(noise.cycle + e)`` for epoch ``e``, each epoch owning
    its share of the word axis.  ``program`` overrides the programmed
    thresholds fed into the perturbation.
    """
    drift_epochs = int(drift_epochs)
    if drift_epochs > 1 and noise is None:
        raise ValueError("drift_epochs > 1 needs a NoiseModel to advance")
    order = spec.topo_order()
    index = {name: i for i, name in enumerate(order)}
    perturbed = (
        perturbed_cdf_rows(spec, noise, program=program)
        if noise is not None or program is not None else None
    )
    nodes = []
    for name in order:
        node = spec.node(name)
        if perturbed is not None:
            rows = perturbed[name]
        else:
            rows = tuple(rng.cdf_thresholds_int(r) for r in spec.cpt_rows(name))
        nodes.append((tuple(index[p] for p in node.parents), spec.card(name), rows))
    epoch_rows = []
    for e in range(1, drift_epochs):
        pe = perturbed_cdf_rows(
            spec, noise.with_cycle(noise.cycle + e), program=program
        )
        epoch_rows.append(tuple(pe[name] for name in order))
    return SweepPlan(
        nodes=tuple(nodes),
        evidence=tuple(index[e] for e in evidence),
        queries=tuple(index[q] for q in queries),
        epochs=drift_epochs,
        epoch_rows=tuple(epoch_rows),
    )


def compile_network(
    spec: NetworkSpec,
    n_bits: int = 4096,
    queries: Sequence[str] | None = None,
    evidence: Sequence[str] | None = None,
    *,
    share_entropy: bool = False,
    estimator: str = "ratio",
    fused: bool | None = None,
    mux_mode: str = "gather",
    noise: NoiseModel | None = None,
    drift_epochs: int = 1,
    program: dict | None = None,
    devices: int | None = None,
    device="cuda",
    trace: Tracer | None = None,
) -> CompiledNetwork:
    """Lower ``spec`` to a fused, frame-batched packed-stochastic program.

    ``device`` (default ``"cuda"``) is where every launch runs: the CUDA
    kernel on the card, or its plain torch version for ``device="cpu"``.
    ``noise`` injects crossbar non-idealities at plan-build time, and
    ``drift_epochs`` / ``program`` shape the plan as in :func:`sweep_plan`.
    ``trace`` records the lowering as a ``compile_network`` span carrying
    :func:`network_stats`.
    """
    if trace is not None:
        with trace.span("compile_network", network=spec.name, n_bits=n_bits) as sp:
            net = compile_network(
                spec, n_bits, queries, evidence, share_entropy=share_entropy,
                estimator=estimator, fused=fused, mux_mode=mux_mode,
                noise=noise, drift_epochs=drift_epochs, program=program,
                devices=devices, device=device,
            )
            sp.attrs.update(network_stats(net))
            return net
    dev = backend.resolve_device(device)
    queries = tuple(queries if queries is not None else spec.queries)
    evidence = tuple(evidence if evidence is not None else spec.evidence)
    if not queries:
        raise ValueError(f"{spec.name}: no query nodes")
    if estimator not in ("ratio", "fill"):
        raise ValueError(f"unknown estimator {estimator!r}")
    if n_bits % 32:
        raise ValueError("n_bits must be a multiple of 32 (packed words)")
    if mux_mode not in ("gather", "rows"):
        raise ValueError(f"unknown mux_mode {mux_mode!r}")
    if noise is not None and not isinstance(noise, NoiseModel):
        raise TypeError(f"noise must be a NoiseModel or None, got {type(noise)!r}")
    drift_epochs = int(drift_epochs)
    if drift_epochs < 1:
        raise ValueError(f"drift_epochs must be >= 1, got {drift_epochs}")
    if drift_epochs > n_bits // 32:
        raise ValueError(
            f"drift_epochs={drift_epochs} exceeds the {n_bits // 32} packed "
            f"words of n_bits={n_bits} (an epoch owns at least one word)"
        )
    if drift_epochs > 1 and noise is None:
        raise ValueError("drift_epochs > 1 needs a NoiseModel to advance")
    if program is not None:
        unknown = set(program) - set(spec.topo_order())
        if unknown:
            raise ValueError(f"program covers unknown nodes {sorted(unknown)}")
    unfused = {
        "fused=False": fused is False,
        "share_entropy=True": share_entropy,
        "estimator='fill'": estimator == "fill",
        "mux_mode='rows'": mux_mode == "rows",
    }
    asked = [k for k, v in unfused.items() if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)} needs the unfused lowering, which the port "
            f"does not have yet: {_UNFUSED_TODO}"
        )
    if devices is not None and int(devices) > 1:
        raise NotImplementedError(
            f"devices={devices}: multi-device launches are not ported yet: {_DEVICES_TODO}"
        )
    plan = sweep_plan(spec, queries, evidence, noise=noise,
                      drift_epochs=drift_epochs, program=program)
    return CompiledNetwork(
        spec=spec, queries=queries, evidence=evidence, n_bits=n_bits,
        share_entropy=False, estimator=estimator, fused=True,
        query_cards=tuple(spec.card(q) for q in queries), plan=plan,
        device=dev, noise=noise, drift_epochs=drift_epochs, program=program,
    )
