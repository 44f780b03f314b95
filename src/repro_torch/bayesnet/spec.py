"""Declarative Bayesian-network specs over cardinality-``k`` nodes.

A :class:`NetworkSpec` is the compiler's source language: named discrete nodes
(each taking values ``0 .. k-1``), DAG edges, one CPT row per parent
assignment, plus the evidence/query sets the compiled program exposes.  The
spec is pure data -- validation happens at construction, lowering happens in
:mod:`repro_torch.bayesnet.compile`, and the exact oracle in
:mod:`repro_torch.bayesnet.analytic` interprets the same spec, so the two backends
can never drift apart structurally.

CPT convention (the mixed-radix generalisation of ``core/graph.py``'s Fig S8
ordering): for a node with parents ``(P0, .., Pm-1)`` of cardinalities
``(k0, .., km-1)``, the CPT has ``k0 * .. * km-1`` rows, indexed by the
mixed-radix number whose MOST significant digit is ``P0`` -- for two binary
parents the order is 00, 01, 10, 11, exactly as before.

Two CPT spellings:

* **flat binary** (the legacy form, unchanged): a tuple of floats, entry ``i``
  = ``P(node = 1 | parent row i)``.  Only valid for ``k = 2`` nodes whose
  parents are all binary; a root holds its prior as a length-1 tuple.
* **nested rows** (the k-ary form): a tuple of rows, each row a length-``k``
  tuple of per-value probabilities summing to 1.  Required whenever the node
  or any parent has ``k > 2``; also accepted for binary nodes as
  ``((P(0|row), P(1|row)), ...)``.

``Node.categorical`` builds a nested-row node with ``k`` inferred from the row
length.  Binary stays the ``k = 2`` special case with unchanged behaviour
everywhere downstream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Sequence, Tuple

from repro_torch.core.bitops import value_bits  # noqa: F401  (re-exported: spec-level helper)

_ROW_SUM_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class Node:
    """One discrete variable with ``k`` values (``k = 2``: a classic binary node)."""

    name: str
    parents: Tuple[str, ...] = ()
    cpt: Tuple = (0.5,)
    k: int = 2

    def __post_init__(self):
        object.__setattr__(self, "parents", tuple(self.parents))
        if int(self.k) < 2:
            raise ValueError(f"node {self.name!r}: cardinality k={self.k} < 2")
        object.__setattr__(self, "k", int(self.k))
        if len(set(self.parents)) != len(self.parents):
            raise ValueError(f"node {self.name!r}: duplicate parent")
        cpt = tuple(self.cpt)
        if not cpt:
            raise ValueError(f"node {self.name!r}: empty CPT")
        nested = any(isinstance(row, (tuple, list)) for row in cpt)
        if nested:
            if not all(isinstance(row, (tuple, list)) for row in cpt):
                raise ValueError(
                    f"node {self.name!r}: mixed flat/nested CPT entries"
                )
            rows = []
            for row in cpt:
                row = tuple(float(p) for p in row)
                if len(row) != self.k:
                    raise ValueError(
                        f"node {self.name!r}: CPT row has {len(row)} value "
                        f"probabilities for cardinality k={self.k}"
                    )
                for p in row:
                    if not 0.0 <= p <= 1.0:
                        raise ValueError(
                            f"node {self.name!r}: CPT entry {p} outside [0, 1]"
                        )
                if abs(sum(row) - 1.0) > _ROW_SUM_TOL:
                    raise ValueError(
                        f"node {self.name!r}: CPT row {row} sums to {sum(row)}, "
                        f"not 1"
                    )
                rows.append(row)
            object.__setattr__(self, "cpt", tuple(rows))
        else:
            # Legacy flat-binary form: P(node = 1 | row), binary parents only
            # (row count re-validated against true parent cardinalities by
            # NetworkSpec; here the classic 2**m contract is enforced).
            if self.k != 2:
                raise ValueError(
                    f"node {self.name!r}: flat CPT form is binary-only; "
                    f"k={self.k} needs nested per-value rows"
                )
            cpt = tuple(float(p) for p in cpt)
            if len(cpt) != 1 << len(self.parents):
                raise ValueError(
                    f"node {self.name!r}: {len(self.parents)} parents need "
                    f"{1 << len(self.parents)} CPT rows, got {len(cpt)}"
                )
            for p in cpt:
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"node {self.name!r}: CPT entry {p} outside [0, 1]")
            object.__setattr__(self, "cpt", cpt)

    # ------------------------------------------------------------- accessors
    @classmethod
    def categorical(
        cls, name: str, parents: Sequence[str], rows: Sequence[Sequence[float]]
    ) -> "Node":
        """Nested-row constructor with ``k`` inferred from the row length."""
        rows = tuple(tuple(float(p) for p in row) for row in rows)
        if not rows:
            raise ValueError(f"node {name!r}: empty CPT")
        return cls(name=name, parents=tuple(parents), cpt=rows, k=len(rows[0]))

    @property
    def is_flat(self) -> bool:
        """True for the legacy flat-binary CPT spelling."""
        return not isinstance(self.cpt[0], tuple)

    def value_probs(self) -> Tuple[Tuple[float, ...], ...]:
        """Canonical per-row per-value probabilities ``((P(0), .., P(k-1)), ..)``."""
        if self.is_flat:
            return tuple((1.0 - p, p) for p in self.cpt)
        return self.cpt

    @property
    def n_value_bits(self) -> int:
        """Packed bit-planes carrying this node's sampled value."""
        return value_bits(self.k)


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """A validated DAG of :class:`Node` plus evidence/query sets.

    ``evidence``/``queries`` name the observed and posterior-target nodes the
    compiled program is specialised for; both default to empty and can be
    overridden at compile time.  Evidence frames carry one integer in
    ``[0, k)`` per evidence node; a query of cardinality ``k`` yields a
    normalised length-``k`` posterior vector downstream.
    """

    name: str
    nodes: Tuple[Node, ...]
    evidence: Tuple[str, ...] = ()
    queries: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "evidence", tuple(self.evidence))
        object.__setattr__(self, "queries", tuple(self.queries))
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate node names")
        by_name = {n.name: n for n in self.nodes}
        for n in self.nodes:
            for p in n.parents:
                if p not in by_name:
                    raise ValueError(f"{self.name}: {n.name!r} has unknown parent {p!r}")
        for e in self.evidence + self.queries:
            if e not in by_name:
                raise ValueError(f"{self.name}: unknown evidence/query node {e!r}")
        # Row counts against the true parent cardinalities (the flat-binary
        # Node check assumes binary parents; this is the authoritative one).
        for n in self.nodes:
            expect = math.prod(by_name[p].k for p in n.parents)
            got = len(n.value_probs())
            if got != expect:
                raise ValueError(
                    f"{self.name}: node {n.name!r} needs {expect} CPT rows for "
                    f"parent cardinalities "
                    f"{tuple(by_name[p].k for p in n.parents)}, got {got}"
                )
        object.__setattr__(self, "_topo", _toposort(by_name))

    # ------------------------------------------------------------- accessors
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def topo_order(self) -> Tuple[str, ...]:
        """Node names, parents always before children."""
        return self._topo

    def index(self, name: str) -> int:
        """Position of ``name`` in the declared node order."""
        for i, n in enumerate(self.nodes):
            if n.name == name:
                return i
        raise KeyError(name)

    def roots(self) -> Tuple[str, ...]:
        return tuple(n.name for n in self.nodes if not n.parents)

    def max_fan_in(self) -> int:
        return max((len(n.parents) for n in self.nodes), default=0)

    def card(self, name: str) -> int:
        """Cardinality of node ``name``."""
        return self.node(name).k

    def cards(self, names: Iterable[str] | None = None) -> Tuple[int, ...]:
        """Cardinalities of ``names`` (default: declared node order)."""
        if names is None:
            return tuple(n.k for n in self.nodes)
        return tuple(self.card(nm) for nm in names)

    def max_card(self) -> int:
        return max(n.k for n in self.nodes)

    def cpt_rows(self, name: str) -> Tuple[Tuple[float, ...], ...]:
        """Canonical per-value CPT rows of ``name`` (mixed-radix row order)."""
        return self.node(name).value_probs()


def _toposort(by_name: Dict[str, Node]) -> Tuple[str, ...]:
    """Kahn's algorithm; raises on cycles."""
    indeg = {name: len(n.parents) for name, n in by_name.items()}
    children: Dict[str, list] = {name: [] for name in by_name}
    for name, n in by_name.items():
        for p in n.parents:
            children[p].append(name)
    ready = sorted(name for name, d in indeg.items() if d == 0)
    order = []
    while ready:
        name = ready.pop(0)
        order.append(name)
        for c in children[name]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(by_name):
        cyc = sorted(name for name, d in indeg.items() if d > 0)
        raise ValueError(f"cycle through nodes {cyc}")
    return tuple(order)


def chain(name: str, probs: Iterable[float], cond: Iterable[Tuple[float, float]]) -> NetworkSpec:
    """Convenience: a Markov chain root -> n1 -> n2 ... (used in tests/benches).

    ``probs`` gives the root prior; ``cond`` gives (P(child|parent=1),
    P(child|parent=0)) per link.
    """
    probs = list(probs)
    nodes = [Node("x0", (), (probs[0],))]
    for i, (p1, p0) in enumerate(cond):
        nodes.append(Node(f"x{i + 1}", (f"x{i}",), (p0, p1)))
    return NetworkSpec(name=name, nodes=tuple(nodes))
