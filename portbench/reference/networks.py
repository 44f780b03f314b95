"""The decision networks of a configuration file, read as plain data.

Frozen copies of what the program derives from a spec at set-up:
``src/repro_torch/bayesnet/spec.py`` (the topological order by Kahn's
algorithm, the mixed-radix CPT row order, the flat binary CPT spelling) and
``src/repro_torch/core/rng.py::threshold_int`` / ``cdf_thresholds_int`` (each
CPT row's cumulative 8-bit DAC thresholds).  Nothing here reads the program.

A network in the configuration is a dict with ``name``, ``nodes`` (each
``name``, ``parents``, ``k`` and ``cpt``: a flat list of P(node = 1 | row) for
a binary node of binary parents, or one list of k value probabilities per
row), ``evidence`` and ``queries``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Network:
    """A network in topological order, with its DAC thresholds.

    ``parents[i]`` are indices of earlier nodes (the first parent the most
    significant row digit), ``cards[i]`` node i's cardinality, ``rows[i]``
    its CPT rows of value probabilities, ``evidence`` / ``queries`` node
    indices.
    """

    name: str
    names: tuple
    parents: tuple
    cards: tuple
    rows: tuple
    evidence: tuple
    queries: tuple

    def thresholds(self, precision: str = "float32") -> tuple:
        """Per node, per CPT row, its ``k - 1`` cumulative DAC thresholds."""
        return tuple(tuple(cdf_thresholds(r, precision) for r in rows) for rows in self.rows)


def _toposort(nodes) -> tuple:
    """Kahn's algorithm, the ready list kept in name order, as the spec does."""
    indeg = {n["name"]: len(n["parents"]) for n in nodes}
    children = {n["name"]: [] for n in nodes}
    for n in nodes:
        for p in n["parents"]:
            children[p].append(n["name"])
    ready = sorted(name for name, d in indeg.items() if d == 0)
    order = []
    while ready:
        name = ready.pop(0)
        order.append(name)
        for c in children[name]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(nodes):
        raise ValueError("the network has a cycle")
    return tuple(order)


def value_rows(node) -> tuple:
    """A node's CPT as per-row value probabilities."""
    cpt = node["cpt"]
    if cpt and isinstance(cpt[0], (list, tuple)):
        return tuple(tuple(float(v) for v in row) for row in cpt)
    return tuple((1.0 - float(p), float(p)) for p in cpt)


def load(net: dict) -> Network:
    """A :class:`Network` from its configuration entry."""
    nodes = net["nodes"]
    by_name = {n["name"]: n for n in nodes}
    order = _toposort(nodes)
    index = {name: i for i, name in enumerate(order)}
    return Network(
        name=net["name"],
        names=order,
        parents=tuple(tuple(index[p] for p in by_name[nm]["parents"]) for nm in order),
        cards=tuple(int(by_name[nm].get("k", 2)) for nm in order),
        rows=tuple(value_rows(by_name[nm]) for nm in order),
        evidence=tuple(index[e] for e in net["evidence"]),
        queries=tuple(index[q] for q in net["queries"]),
    )


def threshold(p: float, precision: str = "float32") -> int:
    """A probability's 8-bit DAC threshold: round(p * 256), half to even, in
    [0, 256], of p rounded to float32.  The lower precisions are controls:
    ``"bfloat16"`` rounds p to bfloat16 first, ``"dac7"`` is a 7-bit DAC
    (the nearest even threshold, round(p * 128) * 2)."""
    v = float(np.float32(p))
    if precision == "dac7":
        return int(np.clip(2.0 * np.round(v * 128.0), 0.0, 256.0))
    if precision == "bfloat16":
        v = float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).to(torch.float32))
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return int(np.clip(np.round(v * 256.0), 0.0, 256.0))


def cdf_thresholds(probs, precision: str = "float32") -> tuple:
    """``(k - 1,)`` thresholds of ``P(value >= v)``, v = 1 .. k-1, made non-increasing."""
    out, prev = [], 256
    for v in range(1, len(probs)):
        tail = float(np.sum(np.asarray(probs[v:], np.float64)))
        t = min(threshold(tail, precision), prev)
        out.append(t)
        prev = t
    return tuple(out)
