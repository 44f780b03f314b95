"""Batched serving engine: prefill/decode with KV cache, continuous batching,
and the paper's Bayes decision head for timely-reliable emission.

The engine keeps a fixed pool of ``max_batch`` slots.  Requests are admitted
into free slots (continuous batching at step granularity); every engine step
decodes one token for all active slots.  When ``bayes_gate`` is on, per-slot
emission goes through ``models.bayes_head``: posteriors from the model's
decision sources (main head + temperature-perturbed ensemble source) are fused
with eq (5) and a token is only *committed* when fused confidence clears the
threshold -- otherwise it is emitted as a tentative token and flagged (the
serving analogue of the paper's "keep lane / change lane" reliability
branch).  With ``stochastic_gate`` the fusion runs the paper's circuit: one
``bayes_decide`` launch per step.

The reference's engine, step for step: the same admission, pending queue,
recompute-style mid-flight admission and left-padded prompt batch (token 0,
positions ``arange(s)``, no padding mask).  Model calls run eagerly on
``device`` under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import backend
from repro_torch.models import api, bayes_head


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[list] = None
    confidences: Optional[list] = None
    done: bool = False
    admit_step: int = -1               # engine step at which a slot was granted


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 4
    t_cache: int = 128
    bayes_gate: bool = True
    confidence_threshold: float = 0.5
    ensemble_temp: float = 1.3         # second posterior source (perturbed)
    greedy: bool = True
    stochastic_gate: bool = False      # route the gate through the fused
    gate_n_bits: int = 256             # bayes_decide kernel (paper circuit)


def emission_gate(ecfg: EngineConfig, key, last_logits, *, device="cuda"):
    """The engine's emission decision for a batch of logits: (token, conf, ok)."""
    if ecfg.bayes_gate:
        # two conditionally-independent posterior sources: the head itself
        # and a temperature-perturbed view (stand-in for MTP/modality heads);
        # a tensor divisor keeps the division a true division on the card
        temp = torch.full((), ecfg.ensemble_temp, dtype=torch.float32, device=last_logits.device)
        sources = torch.stack([last_logits, last_logits / temp], dim=0)
        if ecfg.stochastic_gate:
            # paper circuit end-to-end: one fused bayes_decide launch
            token, conf = bayes_head.fuse_posteriors_stochastic(
                key, sources, top_k=8, n_bits=ecfg.gate_n_bits, device=device
            )
        else:
            token, conf, _ = bayes_head.fuse_posteriors(sources, top_k=8, device=device)
        ok, token = bayes_head.reliable_decision(token, conf, ecfg.confidence_threshold)
    else:
        token = torch.argmax(last_logits, dim=-1)
        conf = torch.softmax(last_logits, -1).amax(-1)
        ok = torch.ones_like(token, dtype=torch.bool)
    return token, conf, ok


class ServeEngine:
    def __init__(
        self, model_cfg, params, engine_cfg: EngineConfig,
        trace=None, metrics=None, *, device="cuda",
    ):
        self.device = backend.resolve_device(device)
        held = {p.device.type for p in params.parameters()}
        if held != {self.device.type}:
            raise ValueError(f"the params live on {sorted(held)}, the engine on {self.device}")
        self.cfg = model_cfg
        self.params = params
        self.ecfg = engine_cfg
        self.slots: List[Optional[Request]] = [None] * engine_cfg.max_batch
        self.pending: List[Request] = []   # admission queue (continuous batching)
        self.state = None
        self.pos = 0
        self.step_count = 0
        # optional telemetry (repro_torch.obs); None keeps every path untouched
        self.trace = trace
        self.metrics = metrics

    def _decode(self, token, state, pos):
        with torch.inference_mode():
            return api.decode(self.params, self.cfg, token, state, pos)

    def _prefill(self, batch):
        with torch.inference_mode():
            return api.prefill(self.params, self.cfg, batch, self.ecfg.t_cache)

    def _gauge_queues(self):
        """Admission-side visibility: queue depth + slot occupancy gauges."""
        if self.metrics is not None:
            self.metrics.set_gauge("pending_depth", len(self.pending))
            self.metrics.set_gauge(
                "active_slots", sum(s is not None for s in self.slots)
            )

    # ------------------------------------------------------------- admission
    def add_requests(self, requests: List[Request]):
        """Admit into free slots; overflow waits in the pending queue.

        Queued requests are granted slots as decodes complete (``step`` calls
        ``_admit_pending`` after freeing slots) -- true continuous batching:
        submission never fails, admission happens at step granularity.
        """
        for r in requests:
            r.out_tokens, r.confidences = [], []
            self.pending.append(r)
        if self.metrics is not None:
            self.metrics.inc("requests_in", len(requests))
        if self.state is None:
            # before the first prefill, slots can be granted directly -- the
            # caller's prefill_all() encodes them.  Mid-flight, a slot grant
            # must come with a cache refresh, so step() handles admission.
            self._fill_free_slots()
        self._gauge_queues()

    def _fill_free_slots(self) -> bool:
        """Move pending requests into free slots; True if any were admitted."""
        admitted = False
        for i, s in enumerate(self.slots):
            if s is None and self.pending:
                r = self.pending.pop(0)
                r.admit_step = self.step_count
                self.slots[i] = r
                admitted = True
                if self.metrics is not None:
                    self.metrics.inc("requests_admitted")
        self._gauge_queues()
        return admitted

    def _admit_pending(self):
        """Grant freed slots to queued requests and (re)prefill the batch.

        Mid-flight admission re-encodes every active slot's prompt plus the
        tokens it has generated so far (recompute-style admission: one prefill
        refreshes the whole cache with the newcomer in place), then decoding
        continues for all slots from the refreshed logits.
        """
        if not self._fill_free_slots():
            return None
        return self.prefill_all()

    def _batch_prompts(self) -> Dict[str, torch.Tensor]:
        # active context per slot = prompt + tokens generated so far
        ctx = [
            None if s is None else np.concatenate(
                [np.asarray(s.prompt, np.int32), np.asarray(s.out_tokens, np.int32)]
            )
            for s in self.slots
        ]
        maxlen = max(len(c) for c in ctx if c is not None)
        toks = np.zeros((self.ecfg.max_batch, maxlen), np.int64)
        for i, c in enumerate(ctx):
            if c is not None:
                toks[i, maxlen - len(c):] = c                 # left-pad
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    # ---------------------------------------------------------------- serve
    def prefill_all(self):
        batch = self._batch_prompts()
        if self.trace is not None:
            with self.trace.span("engine.prefill", tokens=batch["tokens"].shape[1]):
                logits, self.state = self._prefill(batch)
        else:
            logits, self.state = self._prefill(batch)
        self.pos = batch["tokens"].shape[1]
        if self.metrics is not None:
            self.metrics.inc("prefills")
        return logits

    def step(self, key, last_logits) -> Dict[int, tuple]:
        """One decode step for all active slots; returns (logits, {rid: (token, conf, ok)})."""
        if self.trace is None:
            return self._step_impl(key, last_logits)
        with self.trace.span(
            "engine.step", step=self.step_count, pending=len(self.pending)
        ):
            return self._step_impl(key, last_logits)

    def _step_impl(self, key, last_logits):
        token, conf, ok = emission_gate(self.ecfg, key, last_logits, device=self.device)
        logits, self.state = self._decode(token.to(torch.int64), self.state, self.pos)
        self.pos += 1
        self.step_count += 1

        out = {}
        tok_np = token.cpu().numpy()
        conf_np, ok_np = conf.cpu().numpy(), ok.cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None or s.done:
                continue
            s.out_tokens.append(int(tok_np[i]))
            s.confidences.append(float(conf_np[i]))
            out[s.rid] = (int(tok_np[i]), float(conf_np[i]), bool(ok_np[i]))
            if len(s.out_tokens) >= s.max_new_tokens:
                s.done = True
                self.slots[i] = None     # free the slot (continuous batching)
                if self.metrics is not None:
                    self.metrics.inc("requests_done")
        if self.metrics is not None:
            self.metrics.inc("tokens_out", len(out))
            self._gauge_queues()
        if self.pending and any(s is None for s in self.slots):
            refreshed = self._admit_pending()
            if refreshed is not None:
                logits = refreshed       # newcomers decode from the refreshed batch
        return logits, out

    def run(self, key, requests: List[Request], max_steps: int | None = None):
        """Convenience driver: admit (queueing overflow), decode until all done."""
        self.add_requests(requests)
        logits = self.prefill_all()
        active = [s for s in self.slots if s is not None] + self.pending
        steps = max_steps or sum(r.max_new_tokens for r in active)
        for _ in range(steps):
            key, sub = prng.split(key)
            logits, _ = self.step(sub, logits)
            if all(s is None for s in self.slots) and not self.pending:
                break
        return requests
