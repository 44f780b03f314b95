"""The wide network of the port's tests and of ``chip_smoke.py``.

One definition for every place that needs a node above the card kernels'
templated widths.  ``wide_spec`` takes the package whose ``Node`` and
``NetworkSpec`` build it (``repro.bayesnet`` or ``repro_torch.bayesnet``),
so the reference and the port get the same network; this module imports
neither.
"""

import numpy as np


def wide_spec(pkg, m=7, n_cls=0):
    """A binary node ``hub`` with ``m`` binary parents, observed through a
    child ``obs``; with ``n_cls``, also a 3-valued node ``cls`` with
    ``n_cls`` binary parents (9 planes lie above the pattern table's 8),
    whose CPT depends on how many parents are 1.  ``n_cls=0`` leaves the
    network all-binary, as ``mux_mode='rows'`` needs."""
    n = max(m, n_cls)
    roots = tuple(pkg.Node(f"a{i}", (), (0.2 + 0.06 * i,)) for i in range(n))
    r = np.random.default_rng(m)
    hub = pkg.Node("hub", tuple(f"a{i}" for i in range(m)),
                   tuple(float(p) for p in np.round(r.random(1 << m), 3)))
    obs = pkg.Node("obs", ("hub",), (0.1, 0.85))
    if not n_cls:
        return pkg.NetworkSpec(f"wide-{m}", roots + (hub, obs), evidence=("obs", "a1"),
                               queries=("a0", "hub"))
    by_count = r.dirichlet((2.0, 2.0, 2.0), n_cls + 1)
    cls = pkg.Node.categorical("cls", tuple(f"a{i}" for i in range(n_cls)),
                               [tuple(float(x) for x in by_count[bin(i).count("1")])
                                for i in range(1 << n_cls)])
    return pkg.NetworkSpec(f"wide-{m}+{n_cls}", roots + (hub, cls, obs),
                           evidence=("obs", "cls"), queries=("a0", "hub"))
