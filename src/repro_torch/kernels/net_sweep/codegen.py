"""Straight-line C++ from a gate program: the per-plan body of the CUDA kernel.

The reference's Pallas kernel folds each plan into trace-time constants and
compiles one kernel per plan.  The CUDA kernel does the same: :func:`emit`
turns the :class:`~.program.GateProgram` that :func:`~.program.record_program`
lowered (dead code dropped, live words in reused slots) into one function of
32-bit word operations, ``s3 = s1 & s7;`` and so on, with the instruction
fields written as literals -- the node index of ``BASE``, the salt of
``PLANE``, the drift epoch of ``EMASK``, the column and bit of ``EVMASK``
-- and the ``OUT`` rows as per-item popcount sums.  The compiler keeps the
live words in registers.  The word count is a run-time argument (an epoch's
word range follows from it), so one text serves a plan at every ``n_bits``.

The body compiles as CUDA (``csrc/net_sweep_kernel.cuh`` wraps it in the
kernel: item mapping, per-frame count reduction, decision epilogue) and as
host C++ (``NS_HD`` and ``ns_popc`` in ``csrc/net_sweep_common.h``), so it can
be checked against the plain version without a card.

Generated names, in namespace ``ns_gen`` unless the caller picks another:

``kNOut``   count columns: numerators ``0 .. n_s-1``, then the denominator.
``kNQ``     decision columns (queries).
``body(pos, w, w_words, node_stride, kd0, kd1, ev, cnt)``
            adds the popcounts of one (frame, word) item to ``cnt[kNOut]``:
            ``pos`` is the item's global counter ``frame * w_words + w``
            (mod 2**32), ``w`` its word index of ``w_words``,
            ``node_stride`` is ``n_frames * w_words`` (mod 2**32) and
            ``ev`` the frame's evidence row.
``decide(c, o)``
            the frame's per-query argmax from its counts ``c[kNOut]`` (ties to
            the lowest value; ``denom == 0`` decides 0) into ``o[kNQ]``.
"""

from __future__ import annotations

from repro_torch.core import rng
from repro_torch.kernels.net_sweep.common import SweepPlan
from repro_torch.kernels.net_sweep.program import (
    AND, BASE, EMASK, EVMASK, NOT, ONES, OR, OUT, PLANE, XOR, ZERO, GateProgram,
    record_program,
)


def _u32(x: int) -> str:
    return f"0x{x & 0xFFFFFFFF:X}u"


def _gate(op: int, d: int, a: int, b: int) -> str:
    s = f"s{d} = "
    if op == BASE:
        return s + f"ns_lowbias32(({_u32(a)} * node_stride + pos) ^ kd0);"
    if op == PLANE:
        return s + f"ns_lowbias32(s{a} ^ ({_u32(rng.PLANE_SALTS[b])} ^ kd1));"
    if op == AND:
        return s + f"s{a} & s{b};"
    if op == OR:
        return s + f"s{a} | s{b};"
    if op == XOR:
        return s + f"s{a} ^ s{b};"
    if op == NOT:
        return s + f"~s{a};"
    if op == ONES:
        return s + "0xFFFFFFFFu;"
    if op == ZERO:
        return s + "0u;"
    if op == EMASK:   # all-ones where word w lies in drift epoch a of b
        return s + f"ns_emask(w, w_words, {a}u, {b}u);"
    if op == EVMASK:  # all-zero where bit b of evidence column a is set
        return s + f"((e{a} >> {b}u) & 1u) - 1u;"
    raise ValueError(f"unknown gate op {op}")


def _decide(plan: SweepPlan) -> list:
    n_s = plan.n_value_slots
    lines = []
    for q, (card, off) in enumerate(zip(plan.query_cards, plan.slot_offsets)):
        slots = [f"c[{off + v - 1}]" for v in range(1, card)]
        lines.append(f"  {{  // query {q}: card {card}, count slots {off}..{off + card - 2}")
        lines.append(f"    int best = c[{n_s}] - ({' + '.join(slots)}), arg = 0;")
        for v, sl in enumerate(slots, start=1):
            lines.append(f"    if ({sl} > best) {{ best = {sl}; arg = {v}; }}")
        lines.append(f"    o[{q}] = arg;")
        lines.append("  }")
    return lines


def emit(prog: GateProgram, plan: SweepPlan, namespace: str = "ns_gen") -> str:
    """The C++ body of one gate program (see the module docstring)."""
    code = prog.code.tolist()
    ev_cols = sorted({a for op, _, a, _ in code if op == EVMASK})
    out = [
        f"// {len(code)} gates, {prog.n_slots} live words, "
        f"{prog.int_ops_per_word} int ops per word",
        f"namespace {namespace} {{",
        f"constexpr int kNOut = {prog.n_out};",
        f"constexpr int kNQ = {len(plan.queries)};",
        "",
        "NS_HD void body(uint32_t pos, uint32_t w, uint32_t w_words, uint32_t node_stride,",
        "                uint32_t kd0, uint32_t kd1, const int* ev, uint32_t* cnt) {",
        "  (void)pos; (void)w; (void)w_words; (void)node_stride; (void)kd0; (void)kd1;",
        "  (void)ev;",
    ]
    out += [f"  const uint32_t e{c} = (uint32_t)ev[{c}];" for c in ev_cols]
    out.append("  uint32_t " + ", ".join(f"s{i}" for i in range(prog.n_slots)) + ";")
    for op, d, a, b in code:
        if op == OUT:
            out.append(f"  cnt[{b}] += ns_popc(s{a});")
        else:
            out.append("  " + _gate(op, d, a, b))
    out += ["}", "", "NS_HD void decide(const int* c, int* o) {"]
    out += _decide(plan)
    out += ["}", f"}}  // namespace {namespace}", ""]
    return "\n".join(out)


def cuda_source(plan: SweepPlan) -> str:
    """The translation unit of one plan's kernel library: the shared header,
    the generated body and the hand-written kernel around it (``csrc/``)."""
    body = emit(record_program(plan), plan)
    return ("// net_sweep for one gate program; generated by codegen.py\n"
            '#include "net_sweep_common.h"\n\n' + body
            + '\n#include "net_sweep_kernel.cuh"\n')
