"""Drives the decision path: ``compile_network`` then ``CompiledNetwork.decide``.

The configuration holds the networks as data and the stream length; the
traffic mix gives the frames of a call, the ring of evidence arrays sampled
from each network's joint on the host, the calls in flight and the check's
sample.  Call ``i`` takes network ``i mod N`` in the configuration's order
(round robin) and the next evidence array of its ring, hands it over as a
host array with a fresh key, and copies the posteriors, decisions and
accepted counts back into pinned host buffers; the call is done when an event
recorded after the copies fires, that is when its results are on the host.
The copies run on a stream of their own, so that one call's copy overlaps the
next call's sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as gen
from portbench.counts import sweep as counts
from portbench.reference import networks
from portbench.reference import sweep as ref


def port_spec(net: dict):
    """The program's ``NetworkSpec`` of a configuration entry."""
    from repro_torch.bayesnet.spec import NetworkSpec, Node

    nodes = []
    for n in net["nodes"]:
        cpt = n["cpt"]
        if cpt and isinstance(cpt[0], list):
            cpt = tuple(tuple(row) for row in cpt)
        nodes.append(Node(n["name"], tuple(n["parents"]), tuple(cpt), n.get("k", 2)))
    return NetworkSpec(name=net["name"], nodes=tuple(nodes), evidence=tuple(net["evidence"]),
                       queries=tuple(net["queries"]))


# The control: the reference in the program's place with a 7-bit DAC, the
# precision below the configuration's 8-bit thresholds.  (bfloat16 CPT values
# round to the 8-bit grid on most rows, so they would not show a fault.)
CONTROL = "dac7"


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, spans):
        from repro_torch.bayesnet import compile_network

        self.seed, self.device, self.spans = seed, torch.device(device), spans
        self.n_bits = config["n_bits"]
        self.frames = mix["frames_per_call"]
        self.ahead, self.units_per_call = mix["ahead"], self.frames
        self.sample = mix["check"]["frames"]
        self.limits = mix["check"]["limits"]
        self.plain = [networks.load(net) for net in config["networks"]]
        self.nets = [compile_network(port_spec(net), n_bits=self.n_bits, device=self.device)
                     for net in config["networks"]]
        ring = mix["ring"]
        self.evidence = [[gen.sample_evidence(plain, seed, 1000 + ring * j + s, self.frames)
                          for s in range(ring)] for j, plain in enumerate(self.plain)]
        self.buffers = [None] * len(self.nets)
        self.copier = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._work = {}

    # ------------------------------------------------------------------ calls
    def _where(self, i):
        """(network, ring slot, host buffer slot) of call ``i``."""
        n = len(self.nets)
        j, turn = i % n, i // n
        return j, turn % len(self.evidence[j]), turn % self.ahead

    def _host_buffers(self, outs):
        pin = self.device.type == "cuda"
        return [[torch.empty(o.shape, dtype=o.dtype, pin_memory=pin) for o in outs]
                for _ in range(self.ahead)]

    def submit(self, i):
        j, s, b = self._where(i)
        key = gen.call_key(self.seed, i)
        with self.spans("decide"):
            outs = self.nets[j].decide(key, self.evidence[j][s])
        with self.spans("copy"):
            if self.buffers[j] is None:
                self.buffers[j] = self._host_buffers(outs)
            if self.device.type != "cuda":
                for host, o in zip(self.buffers[j][b], outs):
                    host.copy_(o)
                return j, b, None, outs
            # the copy to the host runs on a stream of its own, after the
            # call's work, so that it overlaps the next call's sweep
            swept = torch.cuda.Event()
            swept.record()
            self.copier.wait_event(swept)
            with torch.cuda.stream(self.copier):
                for host, o in zip(self.buffers[j][b], outs):
                    host.copy_(o, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        return j, b, done, outs          # outs live until the copy is done

    def wait(self, handle):
        if handle[2] is not None:
            handle[2].synchronize()

    def warm(self, calls: int):
        """``calls`` rounds of every network, each round's calls in flight
        together, so that every program, shape and buffer is made before the
        window."""
        n = len(self.nets)
        for r in range(calls):
            handles = [self.submit(-1 - (r * n + j)) for j in range(n)]
            for h in handles:
                self.wait(h)

    # ------------------------------------------------------------------ check
    def plan(self, i) -> dict:
        j, s, _ = self._where(i)
        return {"call": i, "net": j, "slot": s, "key": gen.call_key(self.seed, i)}

    def retain(self, i, handle) -> dict:
        post, dec, accepted = (t.numpy().copy() for t in self.buffers[handle[0]][handle[1]])
        return dict(self.plan(i), post=post, dec=dec, accepted=accepted)

    def _answers(self, rec, frames, precision):
        """The reference's (posteriors, decisions, accepted) of frames ``frames``."""
        plain = self.plain[rec["net"]]
        ev = torch.from_numpy(self.evidence[rec["net"]][rec["slot"]][frames])
        numer, denom = ref.counts(plain, plain.thresholds(precision), ev.to(self.device),
                                  torch.from_numpy(frames), self.frames, self.n_bits, rec["key"])
        post, dec = ref.assemble(plain, numer, denom)
        return post, dec, denom

    def check(self, records, rng, control: bool = False) -> dict:
        """The number compared: frames whose posteriors, decisions or accepted
        count differ from the reference's in any place."""
        mismatched = 0
        for rec in records:
            frames = np.sort(rng.choice(self.frames, size=min(self.sample, self.frames),
                                        replace=False))
            want = self._answers(rec, frames, "float32")
            got = (self._answers(rec, frames, CONTROL) if control
                   else (rec["post"][frames], rec["dec"][frames], rec["accepted"][frames]))
            bad = np.zeros(frames.size, bool)
            for g, w in zip(got, want):
                bad |= (np.asarray(g).reshape(frames.size, -1)
                        != np.asarray(w).reshape(frames.size, -1)).any(-1)
            mismatched += int(bad.sum())
        return {"mismatched_frames": mismatched}

    # ------------------------------------------------------------------ counts
    def least_s(self, i, peaks) -> float:
        j = i % len(self.nets)
        if j not in self._work:
            plain = self.plain[j]
            self._work[j] = counts.call_work(plain, plain.thresholds(), self.frames, self.n_bits)
        return self._work[j].least_s(peaks)
