"""The gate program: a ``SweepPlan`` lowered to straight-line word operations.

The reference's Pallas kernel folds each plan's threshold masks into constants
when it is traced.  The CUDA kernel is one generic build for every plan
instead: it interprets a *gate program* that :func:`record_program` lowers
from the plan on the host, once per ``(plan, w_words)``.

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
EMASK   ``dst`` = all-ones if ``a <= w < b`` (global word index) else 0
EVMASK  ``dst`` = 0 if bit ``b`` of evidence column ``a`` is set, else all-ones
OUT     ``count[b] += popcount(r[a])``; ``b`` is the output column
        (``0 .. n_s-1`` numerator slots, ``n_s`` the denominator)
======  ==================================================================

After recording, dead instructions are dropped and the SSA values are packed
into reusable slots (a value's slot is freed after its last read), so the
kernel's per-thread working set is the program's peak live word count.
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
# 32-bit integer operations each instruction costs per word in the kernel
# (lowbias32 = 3 shifts, 3 xors, 2 multiplies; BASE adds the counter add and
# key xor, PLANE the salt/key xor; EMASK two compares and a select; EVMASK a
# load-free shift, and, compare and select; OUT a popcount and an add).
INT_OPS = {BASE: 10, PLANE: 9, AND: 1, OR: 1, XOR: 1, NOT: 1, ONES: 0,
           ZERO: 0, EMASK: 3, EVMASK: 4, OUT: 2}


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

    def __init__(self, w_words: int):
        self.w_words = w_words
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

    def emask(self, lo, hi):
        return self.emit(EMASK, lo, hi)

    def evmask(self, col, b):
        return self.emit(EVMASK, col, b)


@dataclasses.dataclass(frozen=True)
class GateProgram:
    """A slot-allocated gate program for one ``(plan, w_words)``.

    ``code`` is ``(n_ins, 4)`` int32 rows ``(op, dst_slot, a, b)`` in which
    register operands (and ``dst``) are slot numbers below ``n_slots``.
    ``n_out`` is ``n_value_slots + 1`` output columns.
    """

    code: np.ndarray
    n_slots: int
    n_out: int

    @property
    def int_ops_per_word(self) -> int:
        """32-bit integer operations the kernel spends per (frame, word)."""
        return int(sum(INT_OPS[int(op)] for op in self.code[:, 0]))


def _reads(op, a, b):
    n = _READS[op]
    return (a, b)[:n]


@functools.lru_cache(maxsize=256)
def record_program(plan: SweepPlan, w_words: int) -> GateProgram:
    """Lower ``plan`` at ``w_words`` words per frame to a :class:`GateProgram`."""
    rec = _Recorder(w_words)
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
    return GateProgram(
        code=np.asarray(code, np.int32).reshape(-1, 4),
        n_slots=max(n_slots, 1),
        n_out=n_s + 1,
    )
