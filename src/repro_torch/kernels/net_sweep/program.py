"""The gate program: a ``SweepPlan`` lowered to straight-line word operations.

The reference's Pallas kernel folds each plan's threshold masks into constants
when it is traced.  The CUDA kernel does the same: :func:`record_program`
lowers the plan on the host, once per plan, into a *gate program*, and
:mod:`.codegen` writes that program as the straight-line body of the plan's
own kernel.  No instruction depends on the word count, so one program (and
one library) serves a plan at every ``n_bits``.

The program is recorded by running :func:`~.common.sweep_words` -- the walk
that the plain version runs on tensors -- over :class:`_Sym` words, whose
gate operators append instructions instead of computing.  Lowering-time
constant folding (``None`` / all-ones threshold masks, skipped planes, shared
digit indicators) therefore happens exactly as in the plain version.

Instructions are rows ``(op, dst, a, b)`` of int32:

======  ==================================================================
BASE    ``dst = lowbias32((node_off(a) + pos) ^ kd0)``, node ``a``'s first
        hash round; ``node_off(a) = a * n_frames * w_words`` mod 2**32
PLANE   ``dst = lowbias32(r[a] ^ PLANE_SALTS[b] ^ kd1)``
AND     ``dst = r[a] & r[b]``  (OR, XOR likewise)
NOT     ``dst = ~r[a]``
ONES    ``dst = 0xFFFFFFFF``;  ZERO: ``dst = 0``
EMASK   ``dst`` = all-ones if word ``w`` lies in drift epoch ``a`` of ``b``
        (:func:`~.common.epoch_word_bounds` of the launch's ``w_words``)
        else 0
EVMASK  ``dst`` = 0 if bit ``b`` of evidence column ``a`` is set, else all-ones
OUT     ``count[b] += popcount(r[a])``; ``b`` is the output column
        (``0 .. n_s-1`` numerator slots, ``n_s`` the denominator)
======  ==================================================================

After recording, dead instructions are dropped and the SSA values are packed
into reusable slots (a value's slot is freed after its last read), so the
program's peak live word count bounds the kernel's registers per thread.

:attr:`GateProgram.int_ops_per_word` counts the 32-bit integer operations
an item needs at the least on a GPU with a three-input logic instruction
(``LOP3`` on Hopper): a cone of AND/OR/XOR/NOT gates over at most three
values is one operation, NOT is free inside one, and ``ONES``/``ZERO``
fold into the truth table.  :attr:`GateProgram.alu_ops_per_word` is the
part that only the integer ALU runs (logic, shifts, compares, selects,
popcounts); multiplies and adds may also run on Hopper's FMA pipe.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import numpy as np

from repro_torch.kernels.net_sweep.common import SweepPlan, sweep_words

BASE, PLANE, AND, OR, XOR, NOT, ONES, ZERO, EMASK, EVMASK, OUT = range(11)
_READS = {BASE: 0, PLANE: 1, AND: 2, OR: 2, XOR: 2, NOT: 1, ONES: 0, ZERO: 0,
          EMASK: 0, EVMASK: 0, OUT: 1}
LOGIC = (AND, OR, XOR, NOT)
# The least 32-bit integer operations each non-logic instruction needs per
# word, as (ALU-only operations, multiplies and adds).  lowbias32 is 3
# shifts, 3 xors and 2 multiplies; the key (and salt) xor before it folds into
# its first shift-xor (x ^ k ^ (x >> 16) ^ (k >> 16), the key terms one
# per-thread constant), so PLANE is (6, 2) and BASE (6, 3) with the counter
# add.  EMASK: compare and select, and a subtract.  EVMASK depends on the
# frame alone, so per word it costs nothing.  OUT: a popcount and an add.
INT_OPS = {BASE: (6, 3), PLANE: (6, 2), ONES: (0, 0), ZERO: (0, 0), EMASK: (2, 1),
           EVMASK: (0, 0), OUT: (1, 1)}


class _Sym:
    """A symbolic word: gate operators record instructions."""

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
    """The symbolic word algebra of :func:`~.common.sweep_words`."""

    def __init__(self):
        self.ins = []

    def emit(self, op, a=0, b=0):
        self.ins.append((op, len(self.ins), a, b))
        return _Sym(self, len(self.ins) - 1)

    def base(self, n):
        return self.emit(BASE, n)

    def plane(self, base, k):
        return self.emit(PLANE, base.reg, k)

    def zeros(self):
        return self.emit(ZERO)

    def ones(self):
        return self.emit(ONES)

    def emask(self, e, epochs):
        return self.emit(EMASK, e, epochs)

    def evmask(self, col, b):
        return self.emit(EVMASK, col, b)


@dataclasses.dataclass(frozen=True)
class GateProgram:
    """A slot-allocated gate program for one plan.

    ``code`` is ``(n_ins, 4)`` int32 rows ``(op, dst_slot, a, b)`` in which
    register operands (and ``dst``) are slot numbers below ``n_slots``.
    ``n_out`` is ``n_value_slots + 1`` output columns.  ``int_ops_per_word``
    is the least integer work of one (frame, word) item, of which
    ``alu_ops_per_word`` only the ALU runs (module docstring).
    """

    code: np.ndarray
    n_slots: int
    n_out: int
    int_ops_per_word: int
    alu_ops_per_word: int


def _reads(op, a, b):
    n = _READS[op]
    return (a, b)[:n]


def _int_ops(ins) -> tuple:
    """(all, ALU-only) least integer operations of an SSA program per word
    (module docstring): each logic gate folds an operand gate into its own
    three-input operation while their leaves stay at most three, and costs
    one operation unless every gate that reads it folded it in."""
    op_of = {dst: op for op, dst, _, _ in ins if op != OUT}
    cone, reads, folded = {}, {}, {}
    alu = other = 0
    for op, dst, a, b in ins:
        srcs = _reads(op, a, b)
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
    return alu + other, alu


@functools.lru_cache(maxsize=256)
def record_program(plan: SweepPlan) -> GateProgram:
    """Lower ``plan`` to a :class:`GateProgram`."""
    rec = _Recorder()
    outs = sweep_words(plan, rec)
    n_s = plan.n_value_slots
    # column n_s is the denominator (the acceptance word), 0..n_s-1 numerators
    cols = [n_s] + list(range(n_s))
    for w, col in zip(outs, cols):
        rec.ins.append((OUT, -1, w.reg, col))
    ins = rec.ins
    # dead-instruction elimination, backwards from the OUT rows
    live = set()
    keep = []
    for op, dst, a, b in reversed(ins):
        if op == OUT or dst in live:
            keep.append((op, dst, a, b))
            live.update(_reads(op, a, b))
    keep.reverse()
    # slot allocation: free a value's slot after its last read
    last = {}
    for i, (op, dst, a, b) in enumerate(keep):
        for r in _reads(op, a, b):
            last[r] = i
    free, slot_of, n_slots, code = [], {}, 0, []
    for i, (op, dst, a, b) in enumerate(keep):
        reads = _reads(op, a, b)
        ra = slot_of[a] if len(reads) > 0 else a
        rb = slot_of[b] if len(reads) > 1 else b
        for r in set(reads):
            if last[r] == i:
                heapq.heappush(free, slot_of.pop(r))
        if op == OUT:
            code.append((op, 0, ra, rb))
            continue
        if free:
            s = heapq.heappop(free)
        else:
            s, n_slots = n_slots, n_slots + 1
        slot_of[dst] = s
        code.append((op, s, ra, rb))
    ops, alu = _int_ops(keep)
    return GateProgram(
        code=np.asarray(code, np.int32).reshape(-1, 4),
        n_slots=max(n_slots, 1),
        n_out=n_s + 1,
        int_ops_per_word=ops,
        alu_ops_per_word=alu,
    )
