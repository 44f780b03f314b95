"""Compile a :class:`~repro_torch.bayesnet.spec.NetworkSpec` to the packed domain.

Two lowerings share the spec language, as in the reference:

**Fused** (the default for independent entropy and the ratio estimator): the
whole network -- per-node categorical threshold-gather sampling, the
evidence AND, the CORDIV popcount fixed point -- is ONE
:func:`~repro_torch.kernels.net_sweep.net_sweep` launch.  Entropy is
generated in the kernel from counter bit-planes with the frame index folded
into the counters, so every frame draws an independent joint sample and node
streams never reach device memory.

**Unfused** (one launch per node; the verification baseline, and the only
path for shared entropy, the ``fill`` estimator and ``mux_mode='rows'``):

* binary roots     -> ``sne_encode`` (bit-equal to ``rng.encode_packed``).
* k-ary roots      -> the categorical node kernel with no parents (bit-equal to
  ``rng.encode_packed_categorical``).
* all-binary nodes -> ``node_mux`` (``mux_mode='gather'`` or ``'rows'``).
* k-ary nodes, or binary nodes with k-ary parents -> the categorical node
  kernel (``node_mux_categorical_table``) on a table folded at compile time.
* queries          -> the evidence value indicators are ANDed into the
  acceptance stream; each query value indicator ANDed with it is a bitwise
  subset of it.  ``estimator='ratio'`` popcounts both;
  ``estimator='fill'`` runs the word-parallel ``cordiv_fill`` circuit per
  value slot.

Posterior contract (as in the reference): when every query node is binary,
``run`` returns ``(B, n_q)`` of ``P(q=1 | evidence)``; when any query has
``k > 2`` it returns ``(B, n_q, max_k)`` normalised per-value posteriors
(rows of smaller queries zero-padded).  ``decide`` returns the posterior and
the per-query MAP decisions: the fused kernel argmaxes its counts, the
unfused program argmaxes the posterior -- the same decisions.

``device=`` names where the program runs and defaults to the card; asking for
CUDA where there is none raises.  ``devices=N``, or an ambient mesh, shards
the fused sweep's frames over the ranks of the started process group
(:func:`compile_network`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bayesnet.noise import NoiseModel, perturbed_cdf_rows
from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import bitops, cordiv, prng, rng
from repro_torch.distributed import context as dist_context
from repro_torch.distributed import sharding as dist_sharding
from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep import SweepPlan, net_sweep
from repro_torch.kernels.net_sweep import kernel as net_sweep_kernel
from repro_torch.kernels.node_mux import (
    binary_cat_table,
    cat_table,
    node_mux,
    node_mux_categorical_table,
)
from repro_torch.kernels.node_mux.kernel import MAX_PARENTS
from repro_torch.kernels.sne_encode import sne_encode
from repro_torch.obs import Tracer


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


def _slot_assembler(q_cards: Tuple[int, ...]) -> Callable:
    """Slot probabilities -> posterior map, for the ``fill`` estimator.

    Slots hold ``P(q = v | e)`` for values ``1 .. k-1`` per query.  All-binary
    queries keep the ``(B, n_q)`` slot array; otherwise each query becomes
    ``P(q = 0) = clip(1 - sum, 0, 1)`` and its slots, zero-padded to
    ``max_k``, divided by ``max(sum, 1)`` -- the fill slots are independent
    stochastic divisions whose sum can pass 1.
    """
    if all(c == 2 for c in q_cards):
        return lambda slots: slots
    kmax = max(q_cards)

    def assemble(slots: torch.Tensor) -> torch.Tensor:
        cols = []
        off = 0
        for c in q_cards:
            v = slots[:, off : off + c - 1]
            off += c - 1
            s = v.sum(dim=-1, keepdim=True)
            parts = [torch.clamp(1.0 - s, 0.0, 1.0), v]
            if kmax > c:
                parts.append(v.new_zeros(v.shape[:-1] + (kmax - c,)))
            cols.append(torch.cat(parts, dim=-1) / torch.clamp(s, min=1.0))
        return torch.stack(cols, dim=1)

    return assemble


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
    """A network lowered to one fused sweep, or to one launch per node.

    ``run(key, ev_frames (B, n_ev)) -> (post, accepted (B,))`` and
    ``decide(key, ev_frames) -> (post, decisions (B, n_q), accepted)``.
    ``key`` is ``(2,)`` uint32 key data (:mod:`repro_torch.core.prng`);
    results are tensors on ``device``, returned without synchronising.
    ``accepted[b]`` is the number of stream positions that satisfied frame
    ``b``'s evidence, the effective sample count.  ``plan`` is the fused
    program's :class:`SweepPlan` (``None`` when unfused); ``tables`` holds the
    unfused program's per-node tables on ``device`` (``None`` when fused).
    ``mesh`` / ``shard_axes`` / ``n_shards`` describe the frame sharding of a
    fused program (:func:`compile_network`'s ``devices``).  With a ``trace``
    (:class:`~repro_torch.obs.Tracer`), ``run`` and ``decide`` record a
    ``net.run`` or ``net.decide`` span (attrs ``network``, ``frames``) whose
    children are ``net.upload`` (the evidence's conversion and upload, attrs
    ``bytes`` and ``pinned``) and, fused, ``net.sweep`` (the ``net_sweep``
    call, validation to launch) and ``net.assemble`` (the posterior's ops as
    they are enqueued); without one they make no tracer call.
    """

    spec: NetworkSpec
    queries: Tuple[str, ...]
    evidence: Tuple[str, ...]
    n_bits: int
    share_entropy: bool
    estimator: str
    fused: bool
    query_cards: Tuple[int, ...]
    plan: SweepPlan | None = dataclasses.field(repr=False)
    device: torch.device
    n_shards: int = 1
    shard_axes: Tuple[str, ...] = ()
    mesh: object = dataclasses.field(default=None, repr=False, compare=False)
    noise: NoiseModel | None = None
    drift_epochs: int = 1
    program: dict | None = dataclasses.field(default=None, repr=False, compare=False)
    mux_mode: str = "gather"
    tables: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    trace: Tracer | None = dataclasses.field(default=None, repr=False, compare=False)

    def _check_frames(self, ev_frames) -> torch.Tensor:
        if isinstance(ev_frames, torch.Tensor):
            ev = ev_frames.to(device=self.device, dtype=torch.int32)
        else:
            ev = torch.from_numpy(np.asarray(ev_frames, np.int32))
            # pinned and non-blocking: a pageable upload would wait on the stream
            ev = (ev.pin_memory().to(self.device, non_blocking=True)
                  if self.device.type == "cuda" else ev)
        if ev.dim() != 2 or ev.shape[1] != len(self.evidence):
            raise ValueError(
                f"evidence frames must be (B, {len(self.evidence)}), got {tuple(ev.shape)}"
            )
        return ev

    def _assemble(self, numer, denom):
        return _count_assembler(self.query_cards)(numer, denom)

    def run(self, key, ev_frames) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.trace is not None:
            return self._traced("net.run", key, ev_frames, False)
        ev = self._check_frames(ev_frames)
        if not self.fused:
            return self._run_unfused(key, ev)
        numer, denom = self._sweep(key, ev, False)
        return self._assemble(numer, denom), denom

    def decide(self, key, ev_frames) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Posteriors AND per-query MAP decisions.

        The fused kernel argmaxes the per-query count slots itself, so the
        sense->classify->act path is one launch; the unfused program takes
        :func:`posterior_argmax` of its posterior.  Either way the decisions
        equal :func:`posterior_argmax` of the posterior bit for bit.
        """
        if self.trace is not None:
            return self._traced("net.decide", key, ev_frames, True)
        ev = self._check_frames(ev_frames)
        if not self.fused:
            post, denom = self._run_unfused(key, ev)
            return post, posterior_argmax(post), denom
        numer, denom, dec = self._sweep(key, ev, True)
        return self._assemble(numer, denom), dec, denom

    def _traced(self, name: str, key, ev_frames, decide: bool) -> tuple:
        """``run`` or ``decide`` under the network's tracer: the same calls,
        each part in a span of its own."""
        tr = self.trace
        with tr.span(name, network=self.spec.name) as top:
            with tr.span("net.upload") as sp:
                ev = self._check_frames(ev_frames)
                sp.attrs.update(bytes=ev.numel() * ev.element_size(),
                                pinned=self.device.type == "cuda"
                                and not isinstance(ev_frames, torch.Tensor))
            top.attrs["frames"] = ev.shape[0]
            if not self.fused:
                post, denom = self._run_unfused(key, ev)
                return (post, posterior_argmax(post), denom) if decide else (post, denom)
            with tr.span("net.sweep"):
                outs = self._sweep(key, ev, decide)
            with tr.span("net.assemble"):
                post = self._assemble(outs[0], outs[1])
            return (post, outs[2], outs[1]) if decide else (post, outs[1])

    def _sweep(self, key, ev: torch.Tensor, decide: bool):
        """One sweep launch: sharded over the frame axis when it divides.

        Each rank launches ``net_sweep`` on its slice of the global batch
        with the slice's global frame origin, so the sharded launch is bit
        for bit the single one; the outputs are gathered over the world and
        every rank returns the whole batch's.  A batch the shard count does
        not divide runs unsharded on every rank.
        """
        b = ev.shape[0]
        if self.mesh is None or self.n_shards <= 1 or b % self.n_shards:
            return net_sweep(key, ev, plan=self.plan, n_bits=self.n_bits, decide=decide)
        per = b // self.n_shards
        idx = _shard_index(self.mesh, self.shard_axes, self.mesh.get_coordinate())
        outs = net_sweep(key, ev[idx * per:(idx + 1) * per], plan=self.plan, n_bits=self.n_bits,
                         frame0=(idx * per) & 0xFFFFFFFF, total_frames=b, decide=decide)
        cols = [o.reshape(per, -1) for o in outs]
        whole = _gather_frames(self.mesh, self.shard_axes, torch.cat(cols, dim=1), b)
        out, at = [], 0
        for o, c in zip(outs, cols):
            part = whole[:, at:at + c.shape[1]]
            out.append(part.reshape((b,) + tuple(o.shape[1:])))
            at += c.shape[1]
        return tuple(out)

    def _run_unfused(self, key, ev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-node program: lower every node, condition, estimate."""
        streams = _lower(self.tables, key, self.n_bits,
                         None if self.share_entropy else ev.shape[0], self.mux_mode)
        accept = _acceptance(ev, tuple(streams[e] for e in self.evidence), self.n_bits)
        slots = _slot_indicators(streams, self.queries, self.query_cards)
        denom = bitops.popcount(accept)
        if self.estimator == "ratio":
            numer = torch.stack([bitops.popcount(accept & s) for s in slots], dim=-1)
            return self._assemble(numer, denom), denom
        numer = torch.stack([torch.broadcast_to(s, accept.shape) for s in slots], dim=1)
        _, post = cordiv.cordiv_fill(numer & accept[:, None, :], accept[:, None, :],
                                     self.n_bits)
        return _slot_assembler(self.query_cards)(post), denom


def _shard_index(mesh, axes, coord) -> int:
    """A rank's frame shard from its mesh coordinate: row-major over
    ``axes`` (``idx = idx * size + axis_index``), the reference's order."""
    idx = 0
    for a in axes:
        dim = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.shape[dim] + int(coord[dim])
    return idx


def _gather_frames(mesh, axes, part: torch.Tensor, b: int) -> torch.Tensor:
    """Every rank's ``(per, cols)`` shard -> the ``(b, cols)`` whole, on every
    rank.  One ``all_gather`` over the world, which the mesh spans; each
    rank's slot is placed by its own mesh coordinate (:func:`_shard_index`),
    so no group's rank order is assumed.  Ranks that differ only along other
    axes hold equal shards; the first one is taken."""
    dist = torch.distributed
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, part.contiguous())
    per = part.shape[0]
    whole = part.new_empty((b, part.shape[1]))
    done = set()
    for r, got in enumerate(parts):
        idx = _shard_index(mesh, axes, (mesh.mesh == r).nonzero()[0].tolist())
        if idx not in done:
            whole[idx * per:(idx + 1) * per] = got
            done.add(idx)
    return whole


def _slot_indicators(streams, queries, q_cards) -> tuple:
    """Per-query per-value (1..k-1) indicator streams, in slot order."""
    slots = []
    for q, c in zip(queries, q_cards):
        planes = streams[q]
        if c == 2:
            slots.append(planes[0])
        else:
            slots.extend(bitops.digit_indicator(planes, v) for v in range(1, c))
    return tuple(slots)


def _acceptance(ev: torch.Tensor, ev_planes, n_bits: int) -> torch.Tensor:
    """(B, W) acceptance streams: the AND of every evidence value indicator.

    ``ev_planes[i]`` holds evidence node ``i``'s value bit-planes, each
    ``(W,)`` (shared entropy) or ``(B, W)``.  A plane enters as itself where
    the frame's value has that bit set and as its pad-masked complement
    where not.
    """
    mask = bitops.pad_mask(n_bits, device=ev.device)
    accept = mask.expand(ev.shape[0], mask.shape[0])
    zero = torch.zeros((), dtype=torch.int32, device=ev.device)
    for i, planes in enumerate(ev_planes):
        for bit, s in enumerate(planes):
            s = s if s.dim() == 2 else s[None, :]
            ebit = (ev[:, i : i + 1] >> bit) & 1
            accept = accept & (s ^ torch.where(ebit == 1, zero, mask[None, :]))
    return accept


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


def _node_tables(spec: NetworkSpec, noise: NoiseModel | None, program: dict | None,
                 dev: torch.device, mux_mode: str = "gather") -> tuple:
    """The unfused program's per-node tables, uploaded to ``dev`` once.

    One ``(name, parents, cards, table)`` per node in topological order:
    ``table`` is the float32 ``(L,)`` CPT column ``P(node=1 | row)`` of a
    binary node with binary parents (``L = 1`` for a root), else the
    ``(L, k-1)`` cumulative DAC thresholds folded into the categorical
    kernel's table (``node_mux.cat_table``: the parent-pattern table, or the
    rows themselves for wide nodes).  A gather node with more than
    ``MAX_PARENTS`` binary parents is folded the same way at k = 2
    (``node_mux.binary_cat_table``), since the categorical kernels run it.
    ``noise`` / ``program`` route every node through the perturbed integer
    thresholds the fused plan bakes in
    (:func:`~repro_torch.bayesnet.noise.perturbed_cdf_rows`); a binary
    node feeds a threshold ``t`` back as the float32 ``t / 256``, which the
    DAC rounding turns back into ``t`` exactly.
    """
    perturbed = (
        perturbed_cdf_rows(spec, noise, program=program)
        if noise is not None or program is not None else None
    )
    tables = []
    for name in spec.topo_order():
        node = spec.node(name)
        cards = (spec.card(name),) + tuple(spec.card(pn) for pn in node.parents)
        if all(c == 2 for c in cards):
            if perturbed is not None:
                probs = [r[0] / 256.0 for r in perturbed[name]]
            else:
                probs = [r[1] for r in spec.cpt_rows(name)]
            table = torch.tensor(probs, dtype=torch.float32, device=dev)
            if mux_mode == "gather" and len(node.parents) > MAX_PARENTS:
                table = binary_cat_table(table)
        else:
            rows = perturbed[name] if perturbed is not None else tuple(
                rng.cdf_thresholds_int(r) for r in spec.cpt_rows(name))
            table = cat_table(torch.tensor(rows, dtype=torch.int32, device=dev), cards)
        tables.append((name, tuple(node.parents), cards, table))
    return tuple(tables)


def _lower(tables: tuple, key, n_bits: int, batch: int | None, mux_mode: str) -> dict:
    """Launch the per-node sweep over prebuilt :func:`_node_tables`.

    Only launches: every table already lives on the device, so the host never
    waits on the stream here.
    """
    lead = () if batch is None else (batch,)
    streams = {}
    for i, (name, parents, cards, table) in enumerate(tables):
        sub = prng.fold_in(key, i)
        dev = table.device
        if table.dtype == torch.float32:
            if not parents:
                streams[name] = (sne_encode(sub, table[0].expand(lead), n_bits, device=dev),)
                continue
            par = torch.stack([streams[pn][0] for pn in parents])
            streams[name] = (node_mux(sub, table.expand(lead + (-1,)), par, n_bits,
                                      mode=mux_mode, device=dev),)
            continue
        planes = [pl for pn in parents for pl in streams[pn]]
        par = (torch.stack(planes) if planes else
               torch.empty((0,) + lead + (n_bits // 32,), dtype=torch.int32, device=dev))
        out = node_mux_categorical_table(sub, table, par, cards=cards, n_bits=n_bits,
                                         device=dev)
        streams[name] = tuple(out.unbind(0))
    return streams


def lower_streams(
    spec: NetworkSpec,
    key,
    n_bits: int,
    batch: int | None = None,
    *,
    mux_mode: str = "gather",
    noise: NoiseModel | None = None,
    program: dict | None = None,
    device="cuda",
) -> dict:
    """One topological sweep: name -> tuple of packed value bit-planes.

    Every entry is a ``value_bits(k)``-tuple of ``(W,)`` (or ``(B, W)`` with
    ``batch``) int32 words on ``device``.  Node ``i`` of the topological
    order draws its entropy under ``fold_in(key, i)``, so nodes draw disjoint
    counters while each parent's planes feed all its children.  ``noise`` /
    ``program`` perturb the thresholds as :func:`_node_tables` says.
    """
    tables = _node_tables(spec, noise, program, backend.resolve_device(device), mux_mode)
    return _lower(tables, key, n_bits, batch, mux_mode)


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
    """Lower ``spec`` to a frame-batched packed-stochastic program.

    ``fused=None`` picks the one-launch ``net_sweep`` program whenever it
    applies (independent entropy, the ratio estimator, ``mux_mode='gather'``)
    and the per-node unfused program otherwise; ``fused=False`` forces the
    unfused program, the statistical baseline of the fused kernel.
    ``device`` (default ``"cuda"``) is where every launch runs: the CUDA
    kernels on the card, or their plain torch versions for ``device="cpu"``.
    ``noise`` injects crossbar non-idealities at plan-build time, and
    ``drift_epochs`` / ``program`` shape the plan as in :func:`sweep_plan`.
    ``trace`` records the lowering as a ``compile_network`` span carrying
    :func:`network_stats`, and stays on the network, whose ``run`` and
    ``decide`` then record their spans (:class:`CompiledNetwork`).

    ``devices=N`` (fused only) shards the sweep's frames over the N ranks of
    the started process group, one ``net_sweep`` launch per rank on its
    slice; with no ``devices`` argument an ambient
    :func:`~repro_torch.distributed.context.mesh_context` mesh is picked up,
    sharding over its batch axes.  Each shard folds its *global* frame origin
    into the entropy counters, so the sharded program is bit-identical to the
    single-device one, and every rank gets the whole batch's results.  A
    batch the shard count does not divide runs unsharded on every rank.
    Every rank compiles the same network and makes the same calls.
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
            return dataclasses.replace(net, trace=trace)
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
    if mux_mode == "rows" and spec.max_card() > 2:
        raise ValueError(
            "mux_mode='rows' (the binary row-encode baseline) does not "
            "support k-ary nodes; use the default 'gather'"
        )
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
    q_cards = tuple(spec.card(q) for q in queries)
    # The fused sweep samples with threshold-gather by construction, so a
    # non-default mux_mode is a request for the unfused per-node lowering.
    fusable = not share_entropy and estimator == "ratio" and mux_mode == "gather"
    if fused is None:
        fused = fusable
    elif fused and not fusable:
        raise ValueError(
            "fused lowering requires share_entropy=False, estimator='ratio' "
            f"and mux_mode='gather' (got share_entropy={share_entropy}, "
            f"estimator={estimator!r}, mux_mode={mux_mode!r})"
        )
    if devices is not None and int(devices) > 1 and not fused:
        raise ValueError(
            "devices= sharding requires the fused lowering: per-node unfused "
            "programs draw batch-shaped entropy that is not bit-reproducible "
            "across shard boundaries"
        )
    if drift_epochs > 1 and not fused:
        raise ValueError(
            "drift_epochs > 1 requires the fused lowering: the per-node "
            "unfused encoders sample one threshold snapshot per stream"
        )
    if not fused:
        return CompiledNetwork(
            spec=spec, queries=queries, evidence=evidence, n_bits=n_bits,
            share_entropy=share_entropy, estimator=estimator, fused=False,
            query_cards=q_cards, plan=None, device=dev, noise=noise,
            program=program, mux_mode=mux_mode,
            tables=_node_tables(spec, noise, program, dev, mux_mode),
        )
    plan = sweep_plan(spec, queries, evidence, noise=noise,
                      drift_epochs=drift_epochs, program=program)
    mesh, shard_axes = _resolve_frame_mesh(devices, dev)
    if dev.type == "cuda":
        # build the plan's kernel now, so that no launch waits on nvcc
        net_sweep_kernel.prepare([plan])
    return CompiledNetwork(
        spec=spec, queries=queries, evidence=evidence, n_bits=n_bits,
        share_entropy=False, estimator=estimator, fused=True,
        query_cards=q_cards, plan=plan, device=dev,
        n_shards=math.prod(mesh.shape[mesh.mesh_dim_names.index(a)] for a in shard_axes),
        shard_axes=shard_axes, mesh=mesh,
        noise=noise, drift_epochs=drift_epochs, program=program,
    )


def _resolve_frame_mesh(devices, dev: torch.device):
    """Mesh + frame-sharding axes for ``compile_network(devices=...)``.

    ``devices=N`` builds the 1-D ``frames`` mesh over the started world of N
    ranks (:func:`~repro_torch.distributed.context.frame_mesh`);
    ``devices=None`` picks up the ambient mesh, sharding over its batch axes.
    Returns ``(None, ())`` when there is nothing to shard over (one device,
    no mesh, or no batch axis of size above 1 in the mesh).
    """
    if devices is not None:
        if int(devices) == 1:
            return None, ()
        mesh = dist_context.frame_mesh(int(devices), device=dev)
        return mesh, ("frames",)
    mesh = dist_context.current_mesh()
    if mesh is None:
        return None, ()
    if mesh.device_type != dev.type:
        raise ValueError(f"the ambient mesh is on {mesh.device_type!r}, the network on {dev}")
    if mesh.size() != dist_context.world_size():
        raise ValueError(f"the ambient mesh spans {mesh.size()} of the world's "
                         f"{dist_context.world_size()} ranks; the sweep gathers over the world")
    axes = tuple(a for a in dist_sharding.batch_axes(mesh) if a in mesh.mesh_dim_names)
    sizes = dist_sharding.mesh_sizes(mesh)
    if not axes or math.prod(sizes[a] for a in axes) <= 1:
        return None, ()
    return mesh, axes
