"""Scale-out demo: one launch per rank, many ranks, zero reproducibility tax.

Run one rank per device with torchrun:

    PYTHONPATH=src torchrun --standalone --nproc-per-node N -m repro_torch.examples.sharded_sweep

(``--device cpu`` runs the ranks on the CPU, over gloo.)

The compiled network's fused sweep is embarrassingly parallel over frames and
its entropy is a pure function of the global (node, frame, word) counter, so
``compile_network(devices=N)`` gives each rank a slice of the frames and its
global frame origin, and every shard reproduces exactly the bits the
single-device launch would have produced for its slice -- verified below,
then raced.  The FrameDriver's async mode then pipelines launches.

Ranks on a node with a card each join with NCCL; where the ranks outnumber
the cards (two ranks sharing one card), CUDA tensors go over gloo, through
the host.  Without torchrun the script runs as one rank.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bayesnet import FrameDriver, by_name, compile_network, sample_evidence
from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.kernels import backend

CLASSES = ("none", "pedestrian", "vehicle", "cyclist")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dctx.world_size() > 1:
        dist.barrier()


def run(device="cuda", frames: int = 2048, n_bits: int = 4096, reps: int = 5,
        max_batch: int = 512) -> dict:
    """Every rank: the single-device and the sharded obstacle-class network on
    the same ``frames`` (key 1), bit-identity, best-of-``reps`` frames per second of
    each, a fused decide of 4 frames and an async drain of ``max_batch``
    buckets."""
    dev = backend.resolve_device(device)
    n_dev = dctx.world_size()
    spec = by_name("obstacle-class")
    ev = sample_evidence(spec, prng.PRNGKey(1), frames, device=dev)
    key = prng.PRNGKey(0)

    # 1. bit-identity: the sharded launch IS the single-device launch
    single = compile_network(spec, n_bits=n_bits, devices=1, device=dev)
    sharded = compile_network(spec, n_bits=n_bits, devices=n_dev, device=dev)
    p1, a1 = single.run(key, ev)
    pn, an = sharded.run(key, ev)
    identical = bool(torch.equal(p1, pn) and torch.equal(a1, an))

    def bench(net):
        net.run(key, ev)
        best = float("inf")
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            net.run(key, ev)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return frames / best

    f1, fn = bench(single), bench(sharded)

    # 3. the whole sense->classify->act path in the same launch
    post, dec, _ = sharded.decide(key, ev[:4])
    qi = sharded.queries.index("obstacle")

    # 4. async driver: pipeline the queue, block once
    host_ev = ev.cpu().numpy()
    warm = FrameDriver(sharded, max_batch=max_batch, salt=0)
    warm.submit(host_ev[:max_batch])
    warm.drain()
    drv = FrameDriver(sharded, max_batch=max_batch, salt=0)
    drv.submit(host_ev)
    _sync(dev)
    t0 = time.perf_counter()
    out = drv.drain_async()
    dt = time.perf_counter() - t0
    return {
        "devices": n_dev, "device": str(dev), "frames": frames, "n_shards": sharded.n_shards,
        "identical": identical, "single_fps": f1, "sharded_fps": fn,
        "post": post[:, qi].cpu().numpy(), "dec": dec[:, qi].cpu().numpy(),
        "drained": len(out), "launches": -(-frames // max_batch), "drain_s": dt,
    }


def main(device="cuda") -> None:
    dev = backend.resolve_device(device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        rank = int(os.environ.get("LOCAL_RANK", 0))
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        shared = int(os.environ["WORLD_SIZE"]) > torch.cuda.device_count()
        dist.init_process_group("cpu:gloo,cuda:gloo" if dev.type != "cuda" or shared
                                else "cpu:gloo,cuda:nccl")
    r = run(device)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    print(f"devices: {r['devices']} ({r['device']})")
    if not r["identical"]:
        raise SystemExit("sharded posteriors differ from the single-device launch")
    print(f"1. sharded ({r['n_shards']} shards) == single-device: "
          f"bit-identical posteriors over {r['frames']} frames")
    print(f"2. throughput: single {r['single_fps']:,.0f} frames/s, sharded "
          f"{r['sharded_fps']:,.0f} frames/s ({r['sharded_fps'] / r['single_fps']:.2f}x on "
          f"this host -- approaches {r['devices']}x with a card per rank)")
    print("3. fused decide (posterior + argmax, one launch):")
    for i in range(4):
        print(f"   frame {i}: P = {np.round(r['post'][i], 3)} -> {CLASSES[int(r['dec'][i])]}")
    print(f"4. FrameDriver.drain_async: {r['drained']} frames through {r['launches']} "
          f"pipelined launches in {r['drain_s'] * 1e3:.1f} ms "
          f"({r['drained'] / r['drain_s']:,.0f} frames/s)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
    if dist.is_initialized():
        dist.destroy_process_group()
