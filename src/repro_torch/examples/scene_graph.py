"""Scene graphs end to end: Bayesian networks compiled to the packed stochastic
substrate (the generalisation of the Fig S8 motif scripts).

One declarative spec replaces the per-motif wiring: the compiler lowers any
DAG -- binary or cardinality-k categorical -- to counter-entropy SNEs,
parent-gathered DAC CDFs and CORDIV, the enumeration oracle bounds it, and the
frame driver batches streaming evidence.

Run:  PYTHONPATH=src python -m repro_torch.examples.scene_graph
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bayesnet import (
    FrameDriver, NetworkSpec, Node, by_name, compile_network, make_posterior_fn,
    sample_evidence,
)
from repro_torch.core import graph, prng

CPT = ((0.10, 0.60), (0.35, 0.90))
MOTIF = NetworkSpec(
    name="fig-s8b",
    nodes=(
        Node("a1", (), (0.30,)),
        Node("a2", (), (0.70,)),
        Node("b", ("a1", "a2"), CPT[0] + CPT[1]),
    ),
    evidence=("b",), queries=("a1",),
)
NIGHT_FRAME = (1, 0, 1)          # night, no RGB, thermal fires
DAY_FRAME = (0, 1, 1)            # day, both detectors fire
CLASS_FRAME = (1, 0, 2, 2)       # night, rgb=none, th=large, radar=strong
CLASSES = ("none", "pedestrian", "vehicle", "cyclist")


def _timed_run(net, key, ev):
    """(post, acc, seconds of the second call): the first call warms up."""
    net.run(key, ev)
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post, acc = net.run(key, ev)
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    return post, acc, time.perf_counter() - t0


def _oracle_err(spec, ev, post, acc, device):
    exact, _ = make_posterior_fn(spec, dac_quantize=True, device=device)(ev)
    keep = acc > 50
    err = (post - exact).abs()[keep]
    return exact, err, int(keep.sum())


def run(device="cuda", n_frames: int = 2048, n_bits: int = 4096,
        motif_bits: int = 1 << 14) -> dict:
    """The five steps of the reference script: ``motif_bits`` for the Fig S8b
    motif, ``n_frames`` evidence frames at ``n_bits`` for the scenarios."""
    key = prng.PRNGKey(0)
    out = {}
    # 1. a Fig S8 motif is a three-node spec
    net = compile_network(MOTIF, n_bits=motif_bits, device=device)
    out["motif_post"], out["motif_acc"] = net.run(key, np.array([[1]]))
    out["motif_expect"] = graph.analytic_two_parent(0.30, 0.70, CPT, device=device)

    # 2. an 8-node scenario network, n_frames evidence frames, one launch; the
    # fused sweep draws an independent joint sample per frame, the
    # shared-entropy program one for all
    spec = by_name("pedestrian-night")
    net = compile_network(spec, n_bits=n_bits, device=device)
    ev = sample_evidence(spec, prng.PRNGKey(1), n_frames, device=device)
    post, acc, dt = _timed_run(net, key, ev)
    shared = compile_network(spec, n_bits=n_bits, share_entropy=True, device=device)
    out["shared_post"], _, dt_shared = _timed_run(shared, key, ev)
    out.update(spec=spec, ev=ev, post=post, acc=acc, seconds=dt, shared_seconds=dt_shared,
               queries=net.queries)
    # 3. the exact enumeration oracle bounds the stochastic backend
    out["exact"], out["err"], out["kept"] = _oracle_err(spec, ev, post, acc, device)

    # 4. streaming frames through serve-style continuous batching
    # salt 0: the reference script's driver is the first of its process
    drv = FrameDriver(net, max_batch=512, base_key=prng.PRNGKey(2), salt=0)
    drv.submit(np.array(NIGHT_FRAME))
    drv.submit(np.array(DAY_FRAME))
    out["streamed"] = drv.drain()

    # 5. a categorical node: 4-way obstacle classification, posterior and MAP
    # decision in one fused launch
    cspec = by_name("obstacle-class")
    cnet = compile_network(cspec, n_bits=n_bits, device=device)
    cev = sample_evidence(cspec, prng.PRNGKey(3), n_frames, device=device)
    cpost, cacc, cdt = _timed_run(cnet, key, cev)
    _, cerr, _ = _oracle_err(cspec, cev, cpost, cacc, device)
    out.update(class_net=cnet, class_post=cpost, class_acc=cacc, class_seconds=cdt,
               class_err=cerr)
    out["decide"] = cnet.decide(prng.PRNGKey(5), np.stack([np.array(CLASS_FRAME)]))
    return out


def main(device="cuda") -> None:
    r = run(device)
    where = torch.cuda.get_device_name(0) if device == "cuda" else device
    print(f"1. Fig S8b as a spec: P(A1|B=1) = {float(r['motif_post'][0, 0]):.3f} "
          f"(analytic {float(r['motif_expect']):.3f}, {int(r['motif_acc'][0])} accepted bits)")
    spec, n = r["spec"], r["ev"].shape[0]
    print(f"2. {spec.name}: {spec.n_nodes} nodes, queries {r['queries']}, "
          f"{n} frames in {r['seconds'] * 1e3:.2f} ms "
          f"({n / r['seconds']:,.0f} frames/s on {where}, "
          f"independent joint sample per frame; error-correlated shared-entropy "
          f"launch took {r['shared_seconds'] / r['seconds']:.2f}x as long)")
    acc = r["acc"].to(torch.float32)
    print(f"3. vs enumeration oracle: mean |err| {float(r['err'].mean()):.4f}, "
          f"max {float(r['err'].max()):.4f} over {r['kept']} frames "
          f"(stochastic floor ~{1 / np.sqrt(float(acc.median())):.4f})")
    q = r["queries"].index("pedestrian")
    out = r["streamed"]
    print(f"4. streamed frames: P(pedestrian | night, thermal-only) = {out[0][0][q]:.3f}, "
          f"P(pedestrian | day, both) = {out[1][0][q]:.3f}")
    print("   (thermal alone at night is already decisive -- the Fig 4 rescue, "
          "now produced by a compiled network instead of hand-wired operators)")
    cnet = r["class_net"]
    print(f"5. {cnet.spec.name}: obstacle is ONE cardinality-4 node "
          f"({cnet.query_cards[0]}-vector posterior), {n} frames in "
          f"{r['class_seconds'] * 1e3:.2f} ms ({n / r['class_seconds']:,.0f} frames/s), "
          f"mean |err| vs oracle {float(r['class_err'].mean()):.4f}")
    post, dec, _ = r["decide"]
    vec = ", ".join(f"{c}={float(p):.3f}" for c, p in zip(CLASSES, post[0, 0].tolist()))
    print(f"   P(obstacle | night, thermal-large, radar-strong) = [{vec}] "
          f"-> decide: {CLASSES[int(dec[0, 0])].upper()}")


if __name__ == "__main__":
    main()
