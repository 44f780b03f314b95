"""Shared bit-sliced sweep body for the fused whole-network op.

``SweepPlan`` is the static (hashable) description of one compiled network:
per-node parent indices, cardinality, and per-row 8-bit DAC **CDF thresholds**
in topological order, plus the evidence/query node sets.

:func:`sweep_words` is the one walk that defines the fused semantics.  It runs
the topological sweep over an abstract *word algebra*: the words support the
gate operators ``& | ^ ~``, and the algebra supplies the leaves (entropy
bit-planes from the global counter, all-ones / all-zero words, drift-epoch
word masks, evidence literals).  Two algebras use it:

* torch int32 tensors over a ``(frames x words)`` tile -- :func:`sweep_tile`,
  the plain version of the CUDA kernel;
* symbolic words that record each gate as an instruction
  (:mod:`repro_torch.kernels.net_sweep.program`) -- the gate program that
  :mod:`~repro_torch.kernels.net_sweep.codegen` writes out as each plan's
  CUDA kernel body.

So the plain version and the kernel's program come from the same walk, and
both follow the reference's ``sweep_tile`` step for step.

Node sampling is the categorical threshold-gather formulation in bit-sliced
form: entropy arrives as 8 *bit-planes* per output word (``rng.plane_base`` /
``rng.plane_word``) -- ONE byte per stream position regardless of cardinality.
A cardinality-``k`` node carries ``k-1`` non-increasing cumulative thresholds
per CPT row (``C_v`` encodes ``P(value >= v)``); each threshold's gathered
per-plane mask words (an OR of parent-digit indicator words for every CPT row
whose threshold has that bit set -- folded when the plan is lowered) feed the
borrow-chain comparator, the ``k-1`` chains share the node's 8 entropy planes,
and the sampled value ``#{v : byte < C_v}`` is re-packed as ``value_bits(k)``
bit-planes.  Planes below the lowest set threshold bit of a node can never
flip any comparison and are skipped entirely.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import bitops, rng

# Lowering-time sentinel: a threshold-bit mask that is all-ones across the
# tile (every CPT row has this bit set) -- lets the borrow chain drop the AND.
_ONES = object()


def _normalize_node(entry):
    """Accept the legacy ``(parents, scalar thresholds)`` node form.

    Pre-categorical plans carried one 8-bit threshold per CPT row (binary
    nodes only); they normalise to cardinality 2 with one-level CDF rows, so
    existing plan constructions keep working unchanged.
    """
    if len(entry) == 2:
        parents, thresh = entry
        return (tuple(parents), 2, tuple((int(t),) for t in thresh))
    parents, card, rows = entry
    return (tuple(parents), int(card), tuple(tuple(int(t) for t in r) for r in rows))


def _check_rows(i: int, card: int, n_expect: int, rows) -> None:
    """Shared CDF-row validation for base and epoch rows of one node."""
    if len(rows) != n_expect:
        raise ValueError(f"node {i}: needs {n_expect} CPT rows, got {len(rows)}")
    for row in rows:
        if len(row) != card - 1:
            raise ValueError(f"node {i}: CDF row {row} needs {card - 1} thresholds")
        prev = 256
        for t in row:
            if not 0 <= t <= 256:
                raise ValueError(f"node {i}: threshold {t} outside [0, 256]")
            if t > prev:
                raise ValueError(f"node {i}: CDF thresholds {row} not non-increasing")
            prev = t


def epoch_word_bounds(w_words: int, epochs: int) -> Tuple[int, ...]:
    """Word-index partition of a launch's bit-stream into drift epochs.

    ``epochs + 1`` non-decreasing bounds: epoch ``e`` owns words
    ``[bounds[e], bounds[e+1])``.  Maximally even split, earlier epochs take
    the remainder -- a pure function of ``(w_words, epochs)`` shared by the
    sweep lowering and the analytic oracle's mixture weights so both sides
    weight each epoch by exactly the bits it emits.
    """
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    return tuple(round(e * w_words / epochs) for e in range(epochs + 1))


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static lowering of a k-ary DAG network for the fused sweep.

    nodes:    per node (in topological order) a triple ``(parents, card,
              rows)``: ``parents`` are indices of earlier nodes (first parent
              = most significant mixed-radix CPT row digit), ``card`` is the
              node's cardinality, and ``rows`` holds one ``(card - 1,)`` tuple
              of non-increasing cumulative 8-bit DAC thresholds in [0, 256]
              per parent assignment (``rng.cdf_thresholds_int``).  The legacy
              binary pair form ``(parents, thresholds)`` is normalised on
              construction.
    evidence: node index per evidence frame column (values in ``[0, card)``).
    queries:  node index per posterior output; each query of cardinality k
              contributes ``k - 1`` numerator slots (values ``1 .. k-1``; the
              value-0 count is ``denom`` minus their sum).
    epochs:   within-launch drift epochs.  The word axis is split by
              :func:`epoch_word_bounds`; words of epoch ``e > 0`` compare
              against ``epoch_rows[e - 1]`` instead of the base rows --
              modelling the crossbar's read-noise snapshot advancing *during*
              one launch.  Entropy is untouched (the counter layout never
              sees epochs), so ``epochs=1`` is bit-identical to the
              pre-drift plan by construction.
    epoch_rows: ``epochs - 1`` entries, each a per-node tuple of threshold
              row tuples with the same shape as that node's base ``rows``
              (same parents, same cardinality -- only the programmed
              thresholds drift).
    """

    nodes: Tuple
    evidence: Tuple[int, ...]
    queries: Tuple[int, ...]
    epochs: int = 1
    epoch_rows: Tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "nodes", tuple(_normalize_node(e) for e in self.nodes)
        )
        object.__setattr__(self, "evidence", tuple(self.evidence))
        object.__setattr__(self, "queries", tuple(self.queries))
        object.__setattr__(self, "epochs", int(self.epochs))
        object.__setattr__(
            self,
            "epoch_rows",
            tuple(
                tuple(tuple(tuple(int(t) for t in row) for row in node_rows)
                      for node_rows in per_epoch)
                for per_epoch in self.epoch_rows
            ),
        )
        for i, (parents, card, rows) in enumerate(self.nodes):
            if card < 2:
                raise ValueError(f"node {i}: cardinality {card} < 2")
            for p in parents:
                if not 0 <= p < i:
                    raise ValueError(f"node {i}: parent {p} not earlier in topo order")
            expect = math.prod(self.nodes[p][1] for p in parents)
            if len(rows) != expect:
                raise ValueError(
                    f"node {i}: {len(parents)} parents of cardinalities "
                    f"{tuple(self.nodes[p][1] for p in parents)} need {expect} "
                    f"CPT rows, got {len(rows)}"
                )
            _check_rows(i, card, expect, rows)
        for n in self.evidence + self.queries:
            if not 0 <= n < len(self.nodes):
                raise ValueError(f"evidence/query node {n} out of range")
        if not self.queries:
            raise ValueError("SweepPlan needs at least one query node")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if len(self.epoch_rows) != self.epochs - 1:
            raise ValueError(
                f"epochs={self.epochs} needs {self.epochs - 1} epoch_rows "
                f"entries, got {len(self.epoch_rows)}"
            )
        for e, per_epoch in enumerate(self.epoch_rows):
            if len(per_epoch) != len(self.nodes):
                raise ValueError(
                    f"epoch {e + 1}: rows for {len(per_epoch)} nodes, "
                    f"plan has {len(self.nodes)}"
                )
            for i, node_rows in enumerate(per_epoch):
                _check_rows(i, self.nodes[i][1], len(self.nodes[i][2]), node_rows)

    # ------------------------------------------------------------- accessors
    def card(self, i: int) -> int:
        return self.nodes[i][1]

    @property
    def n_value_slots(self) -> int:
        """Numerator count columns: ``sum(card - 1)`` over the query nodes."""
        return sum(self.nodes[q][1] - 1 for q in self.queries)

    @property
    def query_cards(self) -> Tuple[int, ...]:
        """Cardinality per query node, in query order."""
        return tuple(self.nodes[q][1] for q in self.queries)

    @property
    def slot_offsets(self) -> Tuple[int, ...]:
        """First numerator slot column of each query (queries own contiguous
        runs of ``card - 1`` slots, in plan order)."""
        offs, off = [], 0
        for q in self.queries:
            offs.append(off)
            off += self.nodes[q][1] - 1
        return tuple(offs)

    def node_rows(self, n: int, epoch: int = 0) -> Tuple:
        """CDF rows of node ``n`` in drift epoch ``epoch`` (0 = base rows)."""
        return self.nodes[n][2] if epoch == 0 else self.epoch_rows[epoch - 1][n]


class _RowSetGather:
    """Lowering-time-factored OR of CPT-row indicators for one node.

    A threshold-bit mask is the indicator of a *set* of CPT rows.  Building it
    as a flat OR of per-row AND-of-literals words costs ``O(L * m)`` ops per
    mask; factoring the set parent-by-parent (a digit ``d`` whose whole
    sub-space is selected contributes just the digit indicator) and memoising
    the recursive sub-sets -- which repeat heavily across the ``8 * (card-1)``
    masks of a k-ary node -- cuts the gate count severalfold.  Pure boolean
    restructuring: the produced words are value-identical to the flat OR, so
    binary plans stay bit-identical.
    """

    def __init__(self, streams, parents, pcards):
        self.pcards = pcards
        self.sizes = [math.prod(pcards[j:]) for j in range(len(pcards))] + [1]
        self._digits = {}
        self._sets = {}
        self._streams = streams
        self._parents = parents

    def digit(self, j, d):
        if (j, d) not in self._digits:
            self._digits[(j, d)] = bitops.digit_indicator(
                self._streams[self._parents[j]], d
            )
        return self._digits[(j, d)]

    def rows(self, selected):
        """``selected``: iterable of mixed-radix row indices -> mask word,
        ``None`` (empty) or ``_ONES`` (the full parent space)."""
        return self._gather(0, frozenset(selected))

    def _gather(self, j, sel):
        if not sel:
            return None
        if len(sel) == self.sizes[j]:
            return _ONES
        memo_key = (j, sel)
        if memo_key in self._sets:
            return self._sets[memo_key]
        sub_size = self.sizes[j + 1]
        acc = None
        for d in range(self.pcards[j]):
            sub = frozenset(r - d * sub_size for r in sel
                            if d * sub_size <= r < (d + 1) * sub_size)
            inner = self._gather(j + 1, sub)
            if inner is None:
                continue
            term = self.digit(j, d) if inner is _ONES else self.digit(j, d) & inner
            acc = term if acc is None else acc | term
        self._sets[memo_key] = acc
        return acc


def _lt_chain(plane, thresh_masks, hi, words):
    """Bit-sliced ``byte < threshold`` borrow chain over the needed planes.

    ``plane(k)`` returns entropy bit-plane ``k`` (memoised by the caller, so
    the k-1 chains of one categorical node share the node's 8 planes).
    thresh_masks[k] is the packed mask of threshold bit ``k`` per position
    (None = bit clear everywhere, ``_ONES`` = set everywhere); ``hi`` marks
    positions whose threshold is 256 (always fires).  Planes below the lowest
    set threshold bit cannot flip a strict less-than against a zero tail and
    are never generated.
    """
    lo = 8
    for k in range(8):
        if thresh_masks[k] is not None:
            lo = k
            break
    lt = None
    eq = None
    for k in range(7, lo - 1, -1):
        r = plane(k)
        t = thresh_masks[k]
        if t is None:
            eq = ~r if eq is None else eq & ~r
        elif t is _ONES:
            c = ~r if eq is None else eq & ~r
            lt = c if lt is None else lt | c
            eq = r if eq is None else eq & r
        else:
            c = (~r & t) if eq is None else (eq & ~r & t)
            lt = c if lt is None else lt | c
            eq = ~(r ^ t) if eq is None else eq & ~(r ^ t)
    if lt is None:
        lt = words.zeros()
    if hi is not None:
        lt = lt | (words.ones() if hi is _ONES else hi)
    return lt


def _level_masks(rows, level, gather, l):
    """Per-plane gathered mask words + the t=256 short-circuit for one level."""
    if gather is None:  # root: one static row
        t = rows[0][level]
        masks = [(_ONES if (t >> k) & 1 else None) for k in range(8)]
        hi = _ONES if t >= 256 else None
        return masks, hi
    masks = [
        gather.rows([r for r in range(l) if (rows[r][level] >> k) & 1])
        for k in range(8)
    ]
    hi = gather.rows([r for r in range(l) if rows[r][level] >= 256])
    return masks, hi


def _combine_epochs(per_epoch, emasks):
    """OR of per-epoch threshold-bit masks restricted to their word ranges.

    ``per_epoch[e]`` is one epoch's mask (None / ``_ONES`` / word) and
    ``emasks[e]`` the full-ones-where-epoch-``e`` word for the tile.  The
    emasks partition every tile position, so all-None stays None and
    all-``_ONES`` stays ``_ONES`` -- the static short-circuits (and with them
    the skipped-plane optimisation) survive epoching whenever the epochs
    agree on a bit.
    """
    if all(m is None for m in per_epoch):
        return None
    if all(m is _ONES for m in per_epoch):
        return _ONES
    acc = None
    for em, m in zip(emasks, per_epoch):
        if m is None:
            continue
        term = em if m is _ONES else em & m
        acc = term if acc is None else acc | term
    return acc


def _epoch_level_masks(plan, n, level, gather, l, emasks):
    """Epoch-aware :func:`_level_masks`: per-epoch rows folded under emasks.

    One ``_RowSetGather`` serves every epoch of the node (digit indicators
    and recursive row-set words are epoch-independent, so the memo is shared);
    only the selected row sets differ per epoch.
    """
    per_bits = []
    per_hi = []
    for e in range(plan.epochs):
        masks, hi = _level_masks(plan.node_rows(n, e), level, gather, l)
        per_bits.append(masks)
        per_hi.append(hi)
    masks = [
        _combine_epochs([per_bits[e][k] for e in range(plan.epochs)], emasks)
        for k in range(8)
    ]
    hi = _combine_epochs(per_hi, emasks)
    return masks, hi


def decide_counts(plan: SweepPlan, numer: torch.Tensor, denom: torch.Tensor):
    """Decision epilogue: per-query argmax value from the count slots.

    ``numer`` holds the per-query-value acceptance popcounts (values
    ``1 .. card-1`` per query); the value-0 count is ``denom`` minus the
    query's slots.  Ties go to the lowest value (``torch.argmax`` returns the
    first maximum), and a frame with ``denom == 0`` decides value 0.

    numer (..., n_value_slots) i32, denom (...,) i32 -> (..., n_q) i32.
    """
    decs = []
    for q_card, off in zip(plan.query_cards, plan.slot_offsets):
        slots = numer[..., off : off + q_card - 1]
        c0 = denom - slots.sum(dim=-1, dtype=torch.int32)
        counts = torch.cat([c0[..., None], slots], dim=-1)
        decs.append(torch.argmax(counts, dim=-1).to(torch.int32))
    return torch.stack(decs, dim=-1)


def sweep_words(plan: SweepPlan, words):
    """The fused sweep over one word algebra -> the words to popcount.

    ``words`` supplies the leaves: ``base(n)`` (node ``n``'s first hash
    round over its global counters), ``plane(base, k)``, ``zeros()``,
    ``ones()``, ``emask(e, epochs)`` (all-ones on the global words of
    drift epoch ``e``, :func:`epoch_word_bounds` of its own word count) and
    ``evmask(col, b)`` (all-zero where bit ``b`` of evidence column ``col``
    is set, all-ones elsewhere).  Returns
    ``[accept] + [accept & bucket for each query value slot]``: the
    acceptance word (its popcount is ``denom``) and one word per numerator
    slot, queries in plan order, values ``1 .. card-1`` within a query.
    """
    emasks = None
    if plan.epochs > 1:
        # Epoch membership is a pure function of the global word index, so
        # any tiling assigns identical epochs to identical positions.
        emasks = [words.emask(e, plan.epochs) for e in range(plan.epochs)]
    streams = []        # per node: tuple of value bit-plane words
    node_buckets = []   # per node: tuple of value==v indicator words, v=1..k-1
    for n, (parents, card, rows) in enumerate(plan.nodes):
        base = words.base(n)
        l = len(rows)
        if not parents:
            gather = None
        else:
            # first parent = most significant mixed-radix digit (spec.py order)
            pcards = tuple(plan.card(p) for p in parents)
            gather = _RowSetGather(streams, parents, pcards)
        plane_cache = {}

        def plane(k, base=base, plane_cache=plane_cache):
            if k not in plane_cache:
                plane_cache[k] = words.plane(base, k)
            return plane_cache[k]

        levels = []
        for v in range(card - 1):
            if emasks is None:
                masks, hi = _level_masks(rows, v, gather, l)
            else:
                masks, hi = _epoch_level_masks(plan, n, v, gather, l, emasks)
            levels.append(_lt_chain(plane, masks, hi, words))
        bks = bitops.nested_buckets(levels)
        streams.append(tuple(bitops.planes_from_buckets(bks)))
        node_buckets.append(tuple(bks))
    accept = None
    for col, e in enumerate(plan.evidence):
        ind = None
        for b, pl in enumerate(streams[e]):
            term = pl ^ words.evmask(col, b)
            ind = term if ind is None else ind & term
        accept = ind if accept is None else accept & ind
    if accept is None:
        accept = words.ones()
    return [accept] + [accept & bk for q in plan.queries for bk in node_buckets[q]]


class _TensorWords:
    """The torch algebra: int32 words over a ``(bf, bw)`` tile."""

    def __init__(self, kd0, kd1, ev, f0, w0, bf, bw, w_words, n_frames):
        self.kd0, self.kd1 = int(kd0), int(kd1)
        self.ev = ev
        self.w_words = w_words
        self.n_frames = n_frames
        dev = ev.device
        fi = torch.arange(bf, dtype=torch.int64, device=dev)[:, None]
        wi = torch.arange(bw, dtype=torch.int64, device=dev)[None, :]
        self.wglob = int(w0) + wi
        # global counter of (frame, word), wrapped to 32 bits
        self.pos = (((int(f0) + fi) * w_words) + self.wglob) & bitops.MASK32
        self.shape = (bf, bw)

    def base(self, n):
        node_off = (n * self.n_frames * self.w_words) & bitops.MASK32
        return rng.plane_base(self.pos + node_off, self.kd0)

    def plane(self, base, k):
        return bitops.as_i32(rng.plane_word(base, self.kd1, k))

    def zeros(self):
        return torch.zeros(self.shape, dtype=torch.int32, device=self.ev.device)

    def ones(self):
        return torch.full(self.shape, -1, dtype=torch.int32, device=self.ev.device)

    def emask(self, e, epochs):
        lo, hi = epoch_word_bounds(self.w_words, epochs)[e : e + 2]
        inside = (self.wglob >= lo) & (self.wglob < hi)
        return torch.where(inside, -1, 0).to(torch.int32).expand(self.shape)

    def evmask(self, col, b):
        bit = (self.ev[:, col : col + 1] >> b) & 1
        return torch.where(bit == 1, 0, -1).to(torch.int32)


def sweep_tile(
    plan: SweepPlan,
    kd0,
    kd1,
    ev: torch.Tensor,
    f0,
    w0,
    bf: int,
    bw: int,
    w_words: int,
    n_frames: int,
    decide: bool = False,
):
    """Counts for one tile: frames ``[f0, f0+bf)`` x words ``[w0, w0+bw)``.

    The plain torch version of the ``net_sweep`` kernel.  ev: (bf, >= n_ev)
    int32 evidence values for the tile's frames.  Returns ``(numer (bf,
    n_value_slots) int32, denom (bf,) int32)`` over this tile's words, plus
    ``decisions (bf, n_q) int32`` when ``decide=True`` (which needs the full
    word axis in the tile).

    The entropy counter for node ``n``, frame ``f``, word ``w`` is
    ``n * n_frames * w_words + f * w_words + w`` mod ``2**32``, so tiles of
    any shape -- and a slice ``f0`` of a larger batch of ``n_frames`` --
    draw identical bits for identical global positions.
    """
    if decide and bw != w_words:
        raise ValueError(
            f"decide epilogue needs the full word axis in one tile "
            f"(bw={bw}, w_words={w_words}); argmax over partial counts is wrong"
        )
    words = _TensorWords(kd0, kd1, ev, f0, w0, bf, bw, w_words, n_frames)
    outs = sweep_words(plan, words)
    counts = [bitops.popcount(w.expand(bf, bw)) for w in outs]
    denom = counts[0]
    numer = torch.stack(counts[1:], dim=-1)
    if decide:
        return numer, denom, decide_counts(plan, numer, denom)
    return numer, denom


def plan_from_reference(nodes, evidence, queries, epochs=1, epoch_rows=()) -> SweepPlan:
    """A :class:`SweepPlan` from another implementation's plan fields.

    Takes the fields as plain Python / numpy values (``nodes`` triples or
    legacy pairs, ``evidence``, ``queries``, ``epochs``, ``epoch_rows``), so a
    plan lowered elsewhere can be handed to the port and validated here.
    """
    return SweepPlan(
        nodes=tuple(_plain(e) for e in nodes),
        evidence=tuple(int(e) for e in evidence),
        queries=tuple(int(q) for q in queries),
        epochs=int(epochs),
        epoch_rows=_plain(epoch_rows),
    )


def _plain(x):
    """Nested tuples/lists/arrays of integers -> nested tuples of ints."""
    if hasattr(x, "tolist"):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return int(x)
