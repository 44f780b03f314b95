"""Drives the paper's fusion operators (Fig 4, Movie S1) on per-pixel class maps.

The configuration gives the batch (M modalities, K classes, frames of H x W
pixels, n_bits); the traffic mix gives the operator (``bayes_decide``, the
stochastic circuit, or ``fusion_map``, eq 5), the logit scale of each
modality, the ring of input batches made on the device from the seed, the
batches in flight and the check's sample.  Each batch is one call of the
operator's public entry (``repro_torch.kernels``) with a fresh key; its
outputs stay on the device, and the batch is done when an event recorded
after the call fires.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as gen
from portbench.counts import operators as counts
from portbench.reference import fusion as ref


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, spans):
        from repro_torch.kernels import bayes_decide, fusion_map

        self.seed, self.device, self.spans = seed, torch.device(device), spans
        self.m, self.k, self.n_bits = config["modalities"], config["classes"], config["n_bits"]
        self.frames = config["frames_per_batch"]
        self.pixels = self.frames * config["height"] * config["width"]
        self.operator = mix["operator"]
        self.op = {"bayes_decide": bayes_decide, "fusion_map": fusion_map}[self.operator]
        self.ahead, self.units_per_call = mix["ahead"], self.frames
        self.sample = mix["check"]["rows"]
        self.limits = mix["check"]["limits"]
        shape = (self.m, self.frames, config["height"], config["width"], self.k)
        self.ring = [gen.class_posteriors(seed, s, shape, mix["logit_scale"], self.device)
                     for s in range(mix["ring"])]
        self._work = {}

    # ------------------------------------------------------------------ calls
    def _call(self, key, p):
        if self.operator == "bayes_decide":
            return self.op(key, p, self.n_bits, device=self.device)
        return (self.op(p, device=self.device),)

    def submit(self, i):
        slot = i % len(self.ring)
        key = gen.call_key(self.seed, i)
        with self.spans("entry"):
            out = self._call(key, self.ring[slot])
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return slot, key, out, done

    def wait(self, handle):
        if handle[3] is not None:
            handle[3].synchronize()

    def warm(self, calls: int):
        """Run ``calls`` batches at once and keep their outputs until all are
        done, so that the window finds every shape built and every buffer
        the allocator will need."""
        handles = [self.submit(-1 - c) for c in range(calls)]
        for h in handles:
            self.wait(h)

    # ------------------------------------------------------------------ check
    def plan(self, i) -> dict:
        """What the check needs of call ``i`` besides its answers."""
        return {"call": i, "slot": i % len(self.ring), "key": gen.call_key(self.seed, i)}

    def retain(self, i, handle) -> dict:
        return dict(self.plan(i), out=handle[2])

    def _rows(self, rng) -> torch.Tensor:
        n = min(self.sample, self.pixels)
        rows = np.sort(rng.choice(self.pixels, size=n, replace=False))
        return torch.from_numpy(rows).to(self.device)

    def check(self, records, rng, control: bool = False) -> dict:
        """The numbers compared: rows whose decision or any count differs from
        the reference (stochastic), or the largest absolute difference of a
        fused probability from the float64 reference (analytic)."""
        worst, mismatched = 0.0, 0
        for rec in records:
            p = self.ring[rec["slot"]].reshape(self.m, -1, self.k)
            rows = self._rows(rng)
            if self.operator == "bayes_decide":
                want_dec, want_cnt = ref.decide_rows(p, rows, rec["key"], self.n_bits)
                if control:
                    dec, cnt = ref.decide_rows(p, rows, rec["key"], self.n_bits, "bfloat16")
                else:
                    dec_all, cnt_all = rec["out"]
                    dec = dec_all.reshape(-1)[rows]
                    cnt = cnt_all.reshape(-1, self.k)[rows]
                bad = (dec != want_dec) | (cnt != want_cnt).any(-1)
                mismatched += int(bad.sum())
            else:
                want = ref.fusion_rows(p, rows)
                got = (ref.fusion_rows(p, rows, "bfloat16") if control
                       else rec["out"][0].reshape(-1, self.k)[rows].to(torch.float64))
                worst = max(worst, float((got - want).abs().max()))
        if self.operator == "bayes_decide":
            return {"mismatched_rows": mismatched}
        return {"max_abs_err": worst}

    # ------------------------------------------------------------------ counts
    def least_s(self, i, peaks) -> float:
        """The least time of call ``i``'s work on the card (frozen count)."""
        slot = i % len(self.ring)
        if slot not in self._work:
            p = self.ring[slot].reshape(self.m, -1, self.k)
            self._work[slot] = (counts.bayes_decide(p, self.n_bits)
                                if self.operator == "bayes_decide"
                                else counts.fusion_map(self.m, self.pixels, self.k))
        return self._work[slot].least_s(peaks)
