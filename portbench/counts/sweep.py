"""Least integer work of the fused decision sweep, counted from a network.

Frozen copy of the walk of ``src/repro_torch/kernels/net_sweep/common.py``
(``sweep_words`` with ``_RowSetGather``, ``_lt_chain`` and ``_level_masks``,
for one drift epoch), of ``core/bitops.py``'s value planes, and of the count
of ``kernels/net_sweep/program.py`` (``_Recorder``, the dead-instruction
drop of ``record_program`` and ``_int_ops``).  The walk runs over symbolic
words whose gates record instructions; the count then charges, per
(frame, word) item:

* a cone of AND/OR/XOR/NOT gates over at most three values one operation
  (Hopper's ``LOP3``; NOT is free inside one), all on the ALU;
* the first hash round of a node's counter 6 ALU and 3 multiply/add
  operations, each bit-plane's second round 6 and 2, an evidence literal
  nothing (it depends on the frame alone), each popcount with its add 1 and 1.

The count is computed from the network's own thresholds and structure, so a
later change to the program's lowering does not move it.  Per call of B
frames at n_bits: ``B * n_bits / 32`` items.
"""

from __future__ import annotations

import math

BASE, PLANE, AND, OR, XOR, NOT, ONES, ZERO, EVMASK, OUT = range(10)
_READS = {BASE: 0, PLANE: 1, AND: 2, OR: 2, XOR: 2, NOT: 1, ONES: 0, ZERO: 0,
          EVMASK: 0, OUT: 1}
LOGIC = (AND, OR, XOR, NOT)
INT_OPS = {BASE: (6, 3), PLANE: (6, 2), ONES: (0, 0), ZERO: (0, 0), EVMASK: (0, 0),
           OUT: (1, 1)}
_FULL = object()     # a threshold-bit mask set at every CPT row


class _Sym:
    __slots__ = ("rec", "reg")

    def __init__(self, rec, reg):
        self.rec, self.reg = rec, reg

    def __and__(self, other):
        return self.rec.emit(AND, self.reg, other.reg)

    def __or__(self, other):
        return self.rec.emit(OR, self.reg, other.reg)

    def __xor__(self, other):
        return self.rec.emit(XOR, self.reg, other.reg)

    def __invert__(self):
        return self.rec.emit(NOT, self.reg)


class _Recorder:
    def __init__(self):
        self.ins = []

    def emit(self, op, a=0, b=0):
        self.ins.append((op, len(self.ins), a, b))
        return _Sym(self, len(self.ins) - 1)


def _digit(planes, d):
    acc = None
    for b, pl in enumerate(planes):
        lit = pl if (d >> b) & 1 else ~pl
        acc = lit if acc is None else acc & lit
    return acc


class _RowSet:
    """OR of CPT-row indicators, factored parent by parent and memoised."""

    def __init__(self, streams, parents, pcards):
        self.pcards = pcards
        self.sizes = [math.prod(pcards[j:]) for j in range(len(pcards))] + [1]
        self.streams, self.parents = streams, parents
        self.digits, self.sets = {}, {}

    def digit(self, j, d):
        if (j, d) not in self.digits:
            self.digits[(j, d)] = _digit(self.streams[self.parents[j]], d)
        return self.digits[(j, d)]

    def rows(self, selected):
        return self._gather(0, frozenset(selected))

    def _gather(self, j, sel):
        if not sel:
            return None
        if len(sel) == self.sizes[j]:
            return _FULL
        if (j, sel) in self.sets:
            return self.sets[(j, sel)]
        sub_size = self.sizes[j + 1]
        acc = None
        for d in range(self.pcards[j]):
            sub = frozenset(r - d * sub_size for r in sel if d * sub_size <= r < (d + 1) * sub_size)
            inner = self._gather(j + 1, sub)
            if inner is None:
                continue
            term = self.digit(j, d) if inner is _FULL else self.digit(j, d) & inner
            acc = term if acc is None else acc | term
        self.sets[(j, sel)] = acc
        return acc


def _lt_chain(plane, masks, hi, rec):
    """Bit-sliced ``byte < threshold`` over the planes that can decide it."""
    lo = next((k for k in range(8) if masks[k] is not None), 8)
    lt = eq = None
    for k in range(7, lo - 1, -1):
        r, t = plane(k), masks[k]
        if t is None:
            eq = ~r if eq is None else eq & ~r
        elif t is _FULL:
            c = ~r if eq is None else eq & ~r
            lt = c if lt is None else lt | c
            eq = r if eq is None else eq & r
        else:
            c = (~r & t) if eq is None else (eq & ~r & t)
            lt = c if lt is None else lt | c
            eq = ~(r ^ t) if eq is None else eq & ~(r ^ t)
    if lt is None:
        lt = rec.emit(ZERO)
    if hi is not None:
        lt = lt | (rec.emit(ONES) if hi is _FULL else hi)
    return lt


def _level_masks(rows, level, gather):
    if gather is None:
        t = rows[0][level]
        return [(_FULL if (t >> k) & 1 else None) for k in range(8)], (_FULL if t >= 256 else None)
    n = len(rows)
    masks = [gather.rows([r for r in range(n) if (rows[r][level] >> k) & 1]) for k in range(8)]
    return masks, gather.rows([r for r in range(n) if rows[r][level] >= 256])


def _walk(net, thresholds, rec):
    """The sweep's words to popcount: the acceptance word, then one per query value."""
    streams, buckets_of = [], []
    for n, parents in enumerate(net.parents):
        base = rec.emit(BASE, n)
        rows = thresholds[n]
        card = net.cards[n]
        gather = _RowSet(streams, parents, tuple(net.cards[p] for p in parents)) if parents else None
        cache = {}

        def plane(k, base=base, cache=cache):
            if k not in cache:
                cache[k] = rec.emit(PLANE, base.reg, k)
            return cache[k]

        levels = [_lt_chain(plane, *_level_masks(rows, v, gather), rec) for v in range(card - 1)]
        k = len(levels) + 1
        buckets = [levels[v - 1] if v == k - 1 else levels[v - 1] & ~levels[v] for v in range(1, k)]
        planes = []
        for b in range((k - 1).bit_length()):
            sel = [buckets[v - 1] for v in range(1, k) if (v >> b) & 1]
            acc = sel[0]
            for s in sel[1:]:
                acc = acc | s
            planes.append(acc)
        streams.append(tuple(planes))
        buckets_of.append(tuple(buckets))
    accept = None
    for col, e in enumerate(net.evidence):
        ind = None
        for b, pl in enumerate(streams[e]):
            term = pl ^ rec.emit(EVMASK, col, b)
            ind = term if ind is None else ind & term
        accept = ind if accept is None else accept & ind
    if accept is None:
        accept = rec.emit(ONES)
    return [accept] + [accept & bk for q in net.queries for bk in buckets_of[q]]


def _int_ops(ins) -> tuple:
    """(ALU-only, multiply/add) least operations of an SSA program per item."""
    op_of = {dst: op for op, dst, _, _ in ins if op != OUT}
    cone, reads, folded = {}, {}, {}
    alu = other = 0
    for op, dst, a, b in ins:
        srcs = (a, b)[:_READS[op]]
        for r in srcs:
            reads[r] = reads.get(r, 0) + 1
        if op not in LOGIC:
            alu += INT_OPS[op][0]
            other += INT_OPS[op][1]
            continue
        leaves = {r for r in srcs if op_of[r] not in LOGIC and op_of[r] not in (ONES, ZERO)}
        for r in sorted((r for r in srcs if op_of[r] in LOGIC), key=lambda r: len(cone[r])):
            if len(leaves | cone[r]) <= 3:
                leaves |= cone[r]
                folded[r] = folded.get(r, 0) + 1
            else:
                leaves.add(r)
        cone[dst] = frozenset(leaves)
    alu += sum(1 for g in cone if folded.get(g, 0) < reads.get(g, 0))
    return alu, other


def ops_per_item(net, thresholds) -> tuple:
    """(ALU-only, multiply/add) least operations per (frame, word) item."""
    rec = _Recorder()
    outs = _walk(net, thresholds, rec)
    ins = rec.ins + [(OUT, -1, w.reg, 0) for w in outs]
    live, keep = set(), []
    for op, dst, a, b in reversed(ins):
        if op == OUT or dst in live:
            keep.append((op, dst, a, b))
            live.update((a, b)[:_READS[op]])
    keep.reverse()
    return _int_ops(keep)


def call_work(net, thresholds, frames: int, n_bits: int):
    """Least work of one call: (ALU-only ops, multiply/add ops, bytes).

    Bytes: the evidence frames read (4 bytes a value) and the counts and
    decisions written (4 bytes each), once.
    """
    from portbench.counts.operators import Work

    alu, muladd = ops_per_item(net, thresholds)
    items = frames * (n_bits // 32)
    n_slots = sum(net.cards[q] - 1 for q in net.queries)
    nbytes = 4 * frames * (len(net.evidence) + n_slots + 1 + len(net.queries))
    return Work(alu=alu * items, muladd=muladd * items, nbytes=nbytes)
