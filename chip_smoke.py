#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases (any failure makes the script exit non-zero without the result line):

1. device  -- the card's name, power limit and max SM clock (``nvidia-smi``).
2. build   -- ``nvcc`` builds every kernel of the main path from ``src/``
              and prints ``-Xptxas -v`` (registers, spills).
3. kernels -- each kernel against its plain torch version on the card, bit
              for bit: ``net_sweep`` on all 7 scenarios at n_bits=4096,
              B=1024, decide off and on; nominal noise with 3 drift epochs;
              a frame0/total_frames slice whose counters wrap 2**32; and
              n_bits=128.
4. main    -- the port's main path through its entry points: per scenario
              ``compile_network(spec, n_bits=4096, device="cuda")`` and a
              ``FrameDriver(max_batch=256)`` draining 4096 seeded frames in
              sync and in async mode, held per rid against a driver whose
              network was built on the plain version (``device="cpu"``);
              ``decide`` on the card against ``decide`` on the CPU.  Launch
              counts are reset just before and read just after.
5. timing  -- CUDA-event times per launch for each kernel and its plain
              version, frames per second of the async drain, single-frame
              ``decide`` latency p50/p99 at n_bits 128 and 4096.
6. operators -- the paper's fusion operators.  Each of ``sne_encode``,
              ``pand_popcount``, ``bayes_decide`` and ``fusion_map`` against
              its plain torch version on the card (bit for bit; fusion_map
              within atol 2e-6, rtol 1e-5) at M 1..3, K 2 and 16, row counts
              off the block grid and counter origins that wrap 2**32.  Then
              the operator path through its entry points, counts reset just
              before and read just after: the full ``paper-bayes-fusion``
              batch (M=2, K=16, 8 frames of 1080x1920, 128 bits) through
              ``fusion_map``, the fused ``bayes_decide`` and the composed
              ``sne_encode`` -> ``pand_popcount`` -> argmax, which must agree
              on every pixel, with slices of rows held against the plain
              versions at their counter origins; the ``bench_latency``
              decision (4096 decisions, M=K=2, 128 bits: fused, composed,
              ``bayes_decide_packed``); and the ``obstacle_fusion`` example
              flow at 64x64.
7. operator_timing -- CUDA-event times per launch of the four kernels at the
              full batch and at a 65,536-pixel slice of it, beside their plain
              versions (slice only: the plain versions do not fit at full
              size), their bounds, and the composed torch expression for
              ``fusion_map``.
8. unfused_kernels -- the three ``node_mux`` kernels (gather, rows, cat)
              against their plain versions on the card, bit for bit, at 1 to
              3 parents (6 for gather and rows), k-ary nodes with mixed parent
              cards and with no parents, and counter origins that wrap 2**32.
9. unfused_path -- the unfused lowering through its entry points at
              n_bits=4096, B=1024, counts reset just before and read just
              after: 7 scenarios x {``fused=False``, ``share_entropy=True``},
              ``mux_mode='rows'`` on the 4 binary scenarios and
              ``estimator='fill'`` on two, each ``decide`` bit-equal to the
              same program compiled with ``device="cpu"``; a ``FrameDriver``
              over each ``fused=False`` network draining 1024 frames in sync
              and async mode, rid for rid against a ``device="cpu"`` driver.
              Then the unfused, shared-entropy and fused posteriors against the
              enumeration oracle: per distinct evidence vector, the posterior
              pooled over its frames within 4.5 sqrt(p (1-p) / accepted).
10. unfused_timing -- CUDA-event times per launch of the three kernels at
              B=1024 and B=65,536 (n_bits=4096) beside their plain versions
              and bounds; launches of each kernel per unfused ``run`` of each
              scenario; wall time per 1024-frame batch of the unfused, shared
              and fused programs.

Before the last line it prints the ``nvidia-smi`` name/power-limit line and a
``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  The full report also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bayesnet import analytic  # noqa: E402
from repro_torch.bayesnet import (  # noqa: E402
    SCENARIOS,
    FrameDriver,
    NoiseModel,
    by_name,
    compile_network,
    posterior_argmax,
    sweep_plan,
)
from repro_torch.configs.paper_bayes import full_config  # noqa: E402
from repro_torch.core import bitops, prng, rng  # noqa: E402
from repro_torch.data import detection  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    backend,
    bayes_decide,
    bayes_decide_packed,
    fusion_map,
    pand_popcount,
    sne_encode,
)
from repro_torch.kernels.bayes_decide import kernel as bd_kernel  # noqa: E402
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref  # noqa: E402
from repro_torch.kernels.fusion_map import kernel as fm_kernel  # noqa: E402
from repro_torch.kernels.fusion_map.ref import fusion_map_ref, log_prior  # noqa: E402
from repro_torch.kernels.net_sweep import kernel as net_sweep_kernel  # noqa: E402
from repro_torch.kernels.net_sweep import record_program, sweep_tile  # noqa: E402
from repro_torch.kernels.node_mux import kernel as nm_kernel  # noqa: E402
from repro_torch.kernels.node_mux.ref import (  # noqa: E402
    cat_gather_body,
    node_mux_gather_ref,
    node_mux_ref,
)
from repro_torch.kernels.pand_popcount import kernel as pp_kernel  # noqa: E402
from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref  # noqa: E402
from repro_torch.kernels.sne_encode import kernel as sne_kernel  # noqa: E402
from repro_torch.kernels.sne_encode.ref import sne_encode_ref  # noqa: E402
from repro_torch.obs import PAPER_BUDGET_MS  # noqa: E402

NAMES = sorted(SCENARIOS)
N_BITS, BATCH = 4096, 1024            # compile_network's default width, the README's batch
DRAIN_FRAMES, MAX_BATCH = 4096, 256
KD = (0x9E3779B9, 0x7F4A7C15)
INT32_LANES_PER_SM = 64               # Hopper SM, per clock (NVIDIA H100 white paper)
HBM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
TIMED_SCENARIO = "intersection"       # the largest network: the kernels line's numbers
F32_FLOPS_PER_S = 67e12               # H100 SXM float32 outside the tensor cores (data sheet)
# The least integer work per entropy word of sne_encode / bayes_decide: two
# lowbias32 rounds (3 shifts, 3 XORs, 2 multiplies each) and the two key XORs
# (18), plus one compare per comparator byte (4).  Packing, the AND across
# modalities and the popcount come on top and are not counted.
OPS_PER_ENTROPY_WORD = 22
OP_KEY = np.array([0x2545F497, 0x7F4A7C15], np.uint32)      # seed words of the operator runs
OP_SLICE = 4096                       # pixels per slice held against the plain versions
LINE_PIXELS = 65536                   # the kernels line: a slice of the full batch
LAT_DECISIONS, LAT_BITS = 4096, 128   # bench_latency's decision workload (M = K = 2)
FM_ATOL, FM_RTOL = 2e-6, 1e-5         # fusion_map: card logf/expf vs torch log/exp
NM_KEY = np.array([0x85EBCA6B, 0x3C6EF372], np.uint32)     # seed words of the node_mux checks
NM_WRAP = 2**32 - 5000                # a counter origin whose draws wrap 2**32
NM_BIG = 65536                        # rows where the launch no longer dominates (32 MB out)
NM_KERNELS = ("node_mux_gather", "node_mux_rows", "node_mux_cat")
UNFUSED_DRAIN = 1024                  # frames per unfused driver drain
# the unfused path's programs: mode -> compile_network keywords
UNFUSED_MODES = {"unfused": dict(fused=False), "shared": dict(share_entropy=True),
                 "rows": dict(mux_mode="rows"), "fill": dict(estimator="fill")}
KERNEL_MODULES = {
    "net_sweep": net_sweep_kernel, "sne_encode": sne_kernel,
    "pand_popcount": pp_kernel, "bayes_decide": bd_kernel, "fusion_map": fm_kernel,
    "node_mux": nm_kernel,
}
LAUNCHERS = {
    "net_sweep": net_sweep_kernel.net_sweep_cuda, "sne_encode": sne_kernel.sne_encode_cuda,
    "pand_popcount": pp_kernel.pand_popcount_cuda, "bayes_decide": bd_kernel.bayes_decide_cuda,
    "fusion_map": fm_kernel.fusion_map_cuda,
    "node_mux_gather": nm_kernel.node_mux_gather_cuda,
    "node_mux_rows": nm_kernel.node_mux_rows_cuda,
    "node_mux_cat": nm_kernel.node_mux_cat_cuda,
}
REPLACES = {
    "net_sweep": "src/repro/kernels/net_sweep/kernel.py:38",
    "sne_encode": "src/repro/kernels/sne_encode/kernel.py:23",
    "pand_popcount": "src/repro/kernels/pand_popcount/kernel.py:18",
    "bayes_decide": "src/repro/kernels/bayes_decide/kernel.py:27",
    "fusion_map": "src/repro/kernels/fusion_map/kernel.py:18",
    "node_mux_gather": "src/repro/kernels/node_mux/kernel.py:63",
    "node_mux_rows": "src/repro/kernels/node_mux/kernel.py:37",
    "node_mux_cat": "src/repro/kernels/node_mux/kernel.py:86",
}


def _reset_launches():
    for fn in LAUNCHERS.values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def _evidence(spec, b, seed):
    r = np.random.default_rng(seed)
    cols = [r.integers(0, spec.card(e), b) for e in spec.evidence]
    return np.stack(cols, 1).astype(np.int32).reshape(b, len(spec.evidence))


def _plan(name, noise=None, epochs=1):
    spec = by_name(name)
    return sweep_plan(spec, spec.queries, spec.evidence, noise=noise, drift_epochs=epochs)


def _event_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _entropy(key, shape, n_bits, offset):
    """The entropy words of ``shape`` streams of ``n_bits`` at a counter origin, on the card."""
    return rng.counter_hash_words(key, shape, n_bits // 4, offset=offset, device="cuda")


def _int_err(got, want):
    """Max abs difference of two integer tensors (0 when they are equal)."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _float_err(got, want):
    """Max abs difference; raises if outside fusion_map's stated tolerance."""
    if not torch.allclose(got, want, atol=FM_ATOL, rtol=FM_RTOL):
        raise AssertionError(f"fusion_map differs from its plain version beyond atol "
                             f"{FM_ATOL}, rtol {FM_RTOL}")
    return float((got - want).abs().max())


def _composed(key, p, n_bits, device="cuda"):
    """The decision in three steps: sne_encode -> pand_popcount -> argmax."""
    counts = pand_popcount(sne_encode(key, p, n_bits, device=device), device=device)
    return torch.argmax(counts, dim=-1).to(torch.int32), counts


def _class_posteriors(gen, m, r, k):
    """(M, R, K) peaked per-pixel class posteriors: softmax of N(0, 3^2) logits."""
    logits = torch.randn((m, r, k), generator=gen, device="cuda").mul_(3.0)
    return torch.softmax(logits, dim=-1)


def _rand_words(gen, shape):
    """Uniform int32 words on the card (the parent streams of the kernel checks)."""
    return bitops.as_i32(torch.randint(0, 2**32, shape, generator=gen, device="cuda",
                                       dtype=torch.int64))


def _node_table(name, node, b):
    """(table, parent cards, card) of one scenario node, broadcast over ``b`` rows:
    float32 CPT rows (R, L) for an all-binary node, int32 CDF rows (R, L, k-1) else."""
    spec = by_name(name)
    rows = spec.cpt_rows(node)
    card, pcards = spec.card(node), tuple(spec.card(p) for p in spec.node(node).parents)
    if card == 2 and all(c == 2 for c in pcards):
        table = torch.tensor([r[1] for r in rows], dtype=torch.float32, device="cuda")
        return table.expand(b, -1).contiguous(), pcards, card
    table = torch.tensor([rng.cdf_thresholds_int(r) for r in rows], dtype=torch.int32,
                         device="cuda")
    return table.expand(b, -1, -1).contiguous(), pcards, card


def _selected_leaf_words(parents):
    """Entropy words that row-encode needs for these parent streams.

    Each entropy word carries 4 stream positions (a nibble of the output
    word), and a position keeps the byte of the one CPT row its parents
    select (first parent = most significant bit).  So a row's entropy word
    is needed only where one of the 4 positions selects that row: the count
    of distinct rows per nibble, summed over the run's data.
    """
    m, rows, _ = parents.shape
    bit = torch.arange(32, dtype=torch.int32, device=parents.device)
    total = 0
    for r0 in range(0, rows, 4096):
        par = parents[:, r0:r0 + 4096]
        leaf = torch.zeros(par.shape[1:] + (32,), dtype=torch.int32, device=par.device)
        for j in range(m):
            leaf = (leaf << 1) | ((par[j, ..., None] >> bit) & 1)
        a, b, c, d = leaf.view(leaf.shape[:-1] + (8, 4)).unbind(-1)
        total += int((1 + (b != a).int() + ((c != a) & (c != b)).int()
                      + ((d != a) & (d != b) & (d != c)).int()).sum())
    return total


def _nm_calls(name, kd, table, parents, cards, b, n_leaves):
    """(kernel, plain version) of one node_mux launch as zero-argument calls."""
    n_rand_shape = (b, n_leaves) if name == "node_mux_rows" else (b,)

    def entropy():
        return _entropy(NM_KEY, n_rand_shape, N_BITS, 0)

    if name == "node_mux_cat":
        return (lambda: nm_kernel.node_mux_cat_cuda(*kd, table, parents, cards=cards,
                                                    n_bits=N_BITS),
                lambda: cat_gather_body(table, entropy(), parents, cards))
    if name == "node_mux_gather":
        return (lambda: nm_kernel.node_mux_gather_cuda(*kd, table, parents, n_bits=N_BITS),
                lambda: node_mux_gather_ref(table, entropy(), parents))
    return (lambda: nm_kernel.node_mux_rows_cuda(*kd, table, parents, n_bits=N_BITS),
            lambda: node_mux_ref(table, entropy(), parents))


def _pooled_z(ev, post, acc, exact, shared):
    """Largest |z| of a posterior against the oracle, per distinct evidence vector.

    Frames with one evidence vector share its exact posterior.  With
    independent entropy their counts pool (posterior x accepted, summed); with
    shared entropy they are copies, so one frame stands for all.  A group is
    held to 4.5 sqrt(p (1-p) / accepted) of its pooled accepted count, with
    p (1-p) floored at 1e-3 and groups of 50 or fewer accepted bits skipped, as
    the reference's oracle tests do.  Returns (max z, groups checked).
    """
    _, inv = np.unique(ev, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    zmax, groups = 0.0, 0
    for g in range(int(inv.max()) + 1):
        idx = np.flatnonzero(inv == g)[: 1 if shared else None]
        a = acc[idx].astype(np.float64)
        n = a.sum()
        if n <= 50:
            continue
        pooled = (post[idx] * a.reshape((-1,) + (1,) * (post.ndim - 1))).sum(0) / n
        p = exact[idx[0]]
        sigma = np.sqrt(np.clip(p * (1 - p), 1e-3, None) / n)
        zmax = max(zmax, float((np.abs(pooled - p) / sigma).max()))
        groups += 1
    return zmax, groups


def _obstacle_flow(device):
    """examples/obstacle_fusion.py: a 64x64 night scene, analytic fusion of
    RGB and thermal, and the stochastic decision on 4096 pixels at 256 bits."""
    cfg = detection.SceneConfig(height=64, width=64, night_fraction=1.0)
    gt, p_rgb, p_th, _ = detection.make_scene(torch.Generator().manual_seed(0), cfg,
                                              device=device)
    p_modal = torch.stack([torch.stack([q, 1 - q], -1).reshape(-1, 2) for q in (p_rgb, p_th)])
    fused = fusion_map(p_modal, device=device)[:, 0]
    rates = {name: [float(v) for v in detection.detection_metrics(gt, q.reshape(gt.shape))]
             for name, q in (("rgb", p_rgb), ("thermal", p_th), ("fused", fused))}
    dec, cnt = bayes_decide(prng.PRNGKey(1), p_modal[:, :4096], 256, device=device)
    stoch = cnt[:, 0].to(torch.float32) / cnt.sum(-1).clamp(min=1).to(torch.float32)
    return {
        "fused": fused, "dec": dec, "cnt": cnt, "rates": rates,
        "mean_abs_err": float((stoch - fused[:4096]).abs().mean()),
        "agreement": float((dec == (fused[:4096] < 0.5).to(torch.int32)).to(torch.float32).mean()),
    }


class Smoke:
    def __init__(self):
        self.failures = []
        self.report = {"phases": {}}
        self.card = ""

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            ok = True
        except Exception:   # noqa: BLE001 -- a failed phase fails the run, after the others report
            ok = False
            self.failures.append(name)
            traceback.print_exc()
        dt = time.perf_counter() - t0
        self.report["phases"][name] = {"ok": ok, "seconds": dt}
        print(f"phase {name}: {'ok' if ok else 'FAILED'} in {dt:.1f} s", flush=True)

    def say(self, msg):
        print(f"[{self.card}] {msg}", flush=True)

    # ------------------------------------------------------------------ phases
    def device(self):
        self.name_power = _smi("name,power.limit")
        self.card = self.name_power
        self.max_clock_mhz = float(_smi("clocks.max.sm").split()[0])
        props = torch.cuda.get_device_properties(0)
        self.n_sm = props.multi_processor_count
        self.int32_ops_per_s = INT32_LANES_PER_SM * self.n_sm * self.max_clock_mhz * 1e6
        print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}; {self.n_sm} SMs, max SM clock "
              f"{self.max_clock_mhz:.0f} MHz", flush=True)
        self.report["device"] = {
            "name": torch.cuda.get_device_name(0), "nvidia_smi": self.name_power,
            "sms": self.n_sm, "max_sm_mhz": self.max_clock_mhz,
            "int32_ops_per_s": self.int32_ops_per_s,
        }

    def build(self):
        """One nvcc per kernel source, all started together."""
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(KERNEL_MODULES)) as pool:
            built = dict(zip(KERNEL_MODULES, pool.map(
                lambda mod: backend.build_library(mod.SOURCE), KERNEL_MODULES.values())))
        print(f"built {len(built)} kernel libraries in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for name, (path, log) in built.items():
            print(f"{path.name}:\n{log.strip()}", flush=True)
            KERNEL_MODULES[name].library()
        self.report["build_log"] = {name: log for name, (_, log) in built.items()}

    def kernels(self):
        self.max_err = 0
        cases = [(n, None, 1, N_BITS, BATCH, 0, None) for n in NAMES]
        cases += [(n, NoiseModel.nominal(), 3, N_BITS, BATCH, 0, None)
                  for n in ("intersection", "intersection-cat")]
        cases += [("intersection-cat", None, 1, N_BITS, BATCH, 2**27 + 5, 2**28)]
        cases += [(n, None, 1, 128, BATCH, 0, None) for n in NAMES]
        checked = 0
        for name, noise, epochs, n_bits, b, frame0, total in cases:
            plan = _plan(name, noise, epochs)
            ev = torch.from_numpy(_evidence(by_name(name), b, seed=n_bits + epochs)).cuda()
            w = n_bits // 32
            for decide in (False, True):
                got = net_sweep_kernel.net_sweep_cuda(
                    *KD, ev, plan=plan, n_bits=n_bits, frame0=frame0,
                    total_frames=total, decide=decide)
                want = sweep_tile(plan, *KD, ev, frame0, 0, b, w, w,
                                  b if total is None else total, decide=decide)
                torch.cuda.synchronize()
                for g, x in zip(got, want):
                    err = int((g.to(torch.int64) - x.to(torch.int64)).abs().max())
                    self.max_err = max(self.max_err, err)
                    if err:
                        raise AssertionError(
                            f"net_sweep differs from its plain version: {name} "
                            f"n_bits={n_bits} epochs={epochs} frame0={frame0} "
                            f"decide={decide} max abs err {err}")
                checked += 1
        print(f"net_sweep: {checked} launches bit-equal to the plain version "
              f"(max abs err {self.max_err}; tolerance 0: integer counts and "
              f"decisions must match exactly)", flush=True)

    def main_path(self):
        nets = {n: compile_network(by_name(n), n_bits=N_BITS, device="cuda") for n in NAMES}
        plain = {n: compile_network(by_name(n), n_bits=N_BITS, device="cpu") for n in NAMES}
        frames = {n: _evidence(by_name(n), DRAIN_FRAMES, seed=11) for n in NAMES}
        refs = {}
        for i, n in enumerate(NAMES):
            d = FrameDriver(plain[n], max_batch=MAX_BATCH, salt=100 + i)
            d.submit(frames[n])
            refs[n] = (d.drain(), plain[n].decide(prng.PRNGKey(5), frames[n][:BATCH]))
        torch.cuda.synchronize()
        _reset_launches()                                      # the main path starts
        outs = {}
        for i, n in enumerate(NAMES):
            sync = FrameDriver(nets[n], max_batch=MAX_BATCH, salt=100 + i)
            sync.submit(frames[n])
            asyn = FrameDriver(nets[n], max_batch=MAX_BATCH, salt=100 + i)
            asyn.submit(frames[n])
            outs[n] = (sync.drain(), asyn.drain_async(),
                       [t.cpu() for t in nets[n].decide(prng.PRNGKey(5), frames[n][:BATCH])])
        torch.cuda.synchronize()
        counts = _launches()                                   # the main path ends
        self.launches = counts["net_sweep"]
        if self.launches <= 0:
            raise AssertionError("the main path launched the net_sweep kernel 0 times")
        for n in NAMES:
            (ref, (rpost, rdec, racc)) = refs[n]
            sync, asyn, (post, dec, acc) = outs[n]
            q = nets[n].query_cards
            shape = (len(q),) if all(c == 2 for c in q) else (len(q), max(q))
            for out in (sync, asyn):
                if sorted(out) != list(range(DRAIN_FRAMES)):
                    raise AssertionError(f"{n}: drained rids are not 0..{DRAIN_FRAMES - 1}")
                for rid, (p, a) in out.items():
                    rp, ra = ref[rid]
                    if p.shape != shape or not np.all(np.isfinite(p)) or \
                            not np.array_equal(p, rp) or a != ra:
                        raise AssertionError(f"{n}: rid {rid} differs from the plain driver")
                got_dec = posterior_argmax(np.stack([out[r][0] for r in range(DRAIN_FRAMES)]))
                want_dec = posterior_argmax(np.stack([ref[r][0] for r in range(DRAIN_FRAMES)]))
                if not torch.equal(got_dec, want_dec):
                    raise AssertionError(f"{n}: drained decisions differ")
            for g, w in ((post, rpost), (dec, rdec), (acc, racc)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{n}: decide on the card differs from the CPU")
            if not torch.equal(dec, posterior_argmax(post)):
                raise AssertionError(f"{n}: in-kernel decisions differ from the posterior argmax")
            if not (torch.all(post >= 0) and torch.all(post <= 1)):
                raise AssertionError(f"{n}: posterior outside [0, 1]")
        # one decide launch per scenario; the rest are the drains' launches
        per_frame = (self.launches - len(NAMES)) / (2 * DRAIN_FRAMES * len(NAMES))
        print(f"main path: {len(NAMES)} scenarios x (sync + async drains of "
              f"{DRAIN_FRAMES} frames + one decide of {BATCH}) identical to the plain "
              f"driver; net_sweep launches {self.launches} "
              f"({per_frame:.6f} per drained frame)", flush=True)
        self.report["main_path"] = {"launches": counts,
                                    "launches_per_drained_frame": per_frame}

    def timing(self):
        rows = {}
        for n in NAMES:
            spec = by_name(n)
            plan = _plan(n)
            ev = torch.from_numpy(_evidence(spec, BATCH, seed=7)).cuda()
            w = N_BITS // 32
            ms = _event_ms(lambda: net_sweep_kernel.net_sweep_cuda(
                *KD, ev, plan=plan, n_bits=N_BITS), reps=50)
            plain_ms = _event_ms(lambda: sweep_tile(plan, *KD, ev, 0, 0, BATCH, w, w, BATCH),
                                 reps=3, warmup=1)
            prog = record_program(plan, w)
            ops = prog.int_ops_per_word * BATCH * w
            op_ms = ops / self.int32_ops_per_s * 1e3
            nbytes = ev.numel() * 4 + BATCH * prog.n_out * 4 + prog.code.nbytes
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows[n] = {
                "ms": ms, "plain_ms": plain_ms, "int_ops": ops,
                "int_ops_per_word": prog.int_ops_per_word, "instructions": len(prog.code),
                "slots": prog.n_slots, "bytes": nbytes,
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            }
            self.say(f"net_sweep {n}: B={BATCH} n_bits={N_BITS}: kernel {ms:.4f} ms/launch, "
                     f"plain {plain_ms:.3f} ms, bound {rows[n]['bound_ms']:.4f} ms "
                     f"({prog.int_ops_per_word} int ops/word, {len(prog.code)} gates, "
                     f"{prog.n_slots} slots)")
        self.report["net_sweep"] = rows
        fps, lat = {}, {}
        for i, n in enumerate(NAMES):
            net = compile_network(by_name(n), n_bits=N_BITS, device="cuda")
            frames = _evidence(by_name(n), DRAIN_FRAMES, seed=13)
            warm = FrameDriver(net, max_batch=MAX_BATCH, salt=300 + i)
            warm.submit(frames)
            warm.drain_async()
            d = FrameDriver(net, max_batch=MAX_BATCH, salt=400 + i)
            d.submit(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = d.drain_async()
            dt = time.perf_counter() - t0
            assert len(out) == DRAIN_FRAMES
            fps[n] = DRAIN_FRAMES / dt
            self.say(f"FrameDriver {n}: async drain of {DRAIN_FRAMES} frames, max_batch="
                     f"{MAX_BATCH}, n_bits={N_BITS}: {fps[n]:.0f} frames/s")
        for n_bits in (128, N_BITS):
            for n in ("pedestrian-night", "intersection"):
                net = compile_network(by_name(n), n_bits=n_bits, device="cuda")
                ev1 = _evidence(by_name(n), 1, seed=17)
                samples = []
                for k in range(230):
                    t0 = time.perf_counter()
                    post, dec, acc = net.decide(prng.PRNGKey(k), ev1)
                    dec.cpu()
                    samples.append((time.perf_counter() - t0) * 1e3)
                s = np.asarray(samples[30:])
                p50, p99 = float(np.percentile(s, 50)), float(np.percentile(s, 99))
                lat[f"{n}@{n_bits}"] = {"p50_ms": p50, "p99_ms": p99}
                self.say(f"single-frame decide {n} n_bits={n_bits}: p50 {p50:.4f} ms, "
                         f"p99 {p99:.4f} ms (paper budget {PAPER_BUDGET_MS} ms)")
        self.report["frames_per_s"] = fps
        self.report["decide_latency_ms"] = lat

    # ------------------------------------------------------------ operators
    def operators(self):
        self.op_err = {"sne_encode": 0, "pand_popcount": 0, "bayes_decide": 0, "fusion_map": 0.0}
        self._operator_checks()
        self._operator_path()

    def _note(self, name, err):
        self.op_err[name] = max(self.op_err[name], err)
        if name != "fusion_map" and err:
            raise AssertionError(f"{name} differs from its plain version: max abs err {err}")

    def _operator_checks(self):
        """Each kernel against its plain version on the same inputs, on the card."""
        gen = torch.Generator(device="cuda").manual_seed(21)
        kd = rng.seed_words(OP_KEY)
        edge = torch.tensor([0.0, 1.0, 1.5, -0.2, 1 / 512, 3 / 512, 255 / 512, 511 / 512],
                            device="cuda")
        # (M, rows off the block grid, K, n_bits, counter origin)
        cases = [(1, 4099, 2, 128, 0), (2, 4099, 16, 128, 0), (3, 1000, 16, 64, 0),
                 (2, 257, 2, 256, 2**32 - 1000), (3, 333, 16, 96, 2**32 - 5000)]
        for m, r, k, n_bits, offset in cases:
            p = torch.rand((m, r, k), generator=gen, device="cuda")
            p[:, 1] = 0.0                             # every class ties at count 0
            p.view(-1)[: edge.numel()] = edge         # clipped values and DAC half steps
            prior = torch.rand(k, generator=gen, device="cuda") + 0.1
            prior /= prior.sum()
            rand = _entropy(OP_KEY, (m, r, k), n_bits, offset)
            words = sne_kernel.sne_encode_cuda(*kd, p.reshape(-1), n_bits=n_bits, offset=offset)
            counts = pp_kernel.pand_popcount_cuda(words.view(m, r * k, -1))
            dec, cnt = bd_kernel.bayes_decide_cuda(*kd, p, n_bits=n_bits, offset=offset)
            fused = fm_kernel.fusion_map_cuda(p, prior)
            want_words = sne_encode_ref(p.reshape(-1), rand.view(m * r * k, -1))
            want_dec, want_cnt = bayes_decide_ref(p, rand)
            torch.cuda.synchronize()
            self._note("sne_encode", _int_err(words, want_words))
            self._note("pand_popcount", _int_err(
                counts, pand_popcount_ref(words.view(m, r * k, -1))))
            self._note("bayes_decide", max(_int_err(dec, want_dec), _int_err(cnt, want_cnt)))
            self._note("fusion_map", _float_err(fused, fusion_map_ref(p, prior)))
        print(f"operators: {len(cases)} cases (M 1..3, K 2/16, rows off the block grid, "
              f"counter origins wrapping 2**32) equal to the plain versions: max abs err "
              f"{self.op_err} (tolerance 0 for the integer kernels; fusion_map atol "
              f"{FM_ATOL}, rtol {FM_RTOL})", flush=True)

    def _operator_path(self):
        cfg = full_config()
        m, k, n_bits = cfg.modalities, cfg.classes, cfg.n_bits
        r = cfg.frames_per_batch * cfg.height * cfg.width
        n_rand, w = n_bits // 4, n_bits // 32
        gen = torch.Generator(device="cuda").manual_seed(5)
        p = _class_posteriors(gen, m, r, k)
        p[0, :256, 0] = (2 * torch.arange(256, device="cuda") + 1) / 512   # DAC half steps
        p[:, 7] = 0.0                                                      # ties at count 0
        lat_p = torch.rand((2, LAT_DECISIONS, 2), generator=gen, device="cuda")
        lat_want = bayes_decide(OP_KEY, lat_p.cpu(), LAT_BITS, device="cpu")
        obstacle_want = _obstacle_flow("cpu")
        torch.cuda.synchronize()
        _reset_launches()                                   # the operator path starts
        t0 = time.perf_counter()
        fused_map = fusion_map(p)                           # analytic, (R, K)
        dec, cnt = bayes_decide(OP_KEY, p, n_bits)          # fused, one launch
        words = sne_encode(OP_KEY, p, n_bits)               # composed: (M, R, K, W) ...
        counts = pand_popcount(words)                       # ... (R, K) ...
        dec_c = torch.argmax(counts, dim=-1).to(torch.int32)   # ... and the argmax
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        lat = {"fused": bayes_decide(OP_KEY, lat_p, LAT_BITS),
               "composed": _composed(OP_KEY, lat_p, LAT_BITS),
               "packed": bayes_decide_packed(OP_KEY, lat_p, LAT_BITS)}
        obstacle = _obstacle_flow("cuda")
        torch.cuda.synchronize()
        self.op_launches = _launches()                      # the operator path ends
        for name in ("sne_encode", "pand_popcount", "bayes_decide", "fusion_map"):
            if self.op_launches[name] <= 0:
                raise AssertionError(f"the operator path launched {name} 0 times")

        # the full batch: fused == composed on every pixel; output shapes and ranges
        if not (torch.equal(cnt, counts) and torch.equal(dec, dec_c)):
            bad = int((cnt != counts).any(-1).sum())
            raise AssertionError(f"fused bayes_decide differs from the composition on {bad} pixels")
        if tuple(fused_map.shape) != (r, k) or tuple(dec.shape) != (r,) or \
                tuple(words.shape) != (m, r, k, w):
            raise AssertionError("operator outputs have the wrong shapes")
        row_sum = float((fused_map.sum(-1) - 1).abs().max())
        if not (bool(torch.isfinite(fused_map).all()) and row_sum < 1e-5):
            raise AssertionError(f"fusion_map rows are not finite distributions ({row_sum})")
        if int(cnt.min()) < 0 or int(cnt.max()) > n_bits or int(dec[7]) != 0:
            raise AssertionError("counts outside [0, n_bits] or a tied row not decided 0")
        # slices of rows against the plain versions, each at its counter origin
        starts = (0, r // 2 - OP_SLICE // 2, r - OP_SLICE)
        prior = torch.full((k,), 1.0 / k, device="cuda")
        for a in starts:
            rows = slice(a, a + OP_SLICE)
            ps = p[:, rows].contiguous()
            rand = torch.stack([_entropy(OP_KEY, (OP_SLICE, k), n_bits, (mi * r + a) * k * n_rand)
                                for mi in range(m)])
            want_dec, want_cnt = bayes_decide_ref(ps, rand)
            self._note("bayes_decide", max(_int_err(dec[rows], want_dec),
                                           _int_err(cnt[rows], want_cnt)))
            for mi in range(m):
                self._note("sne_encode", _int_err(
                    words[mi, rows].reshape(-1, w),
                    sne_encode_ref(ps[mi].reshape(-1), rand[mi].reshape(-1, n_rand))))
            self._note("pand_popcount", _int_err(
                counts[rows].reshape(-1), pand_popcount_ref(words[:, rows].reshape(m, -1, w))))
            self._note("fusion_map", _float_err(fused_map[rows], fusion_map_ref(ps, prior)))
        agree = float((dec == torch.argmax(fused_map, -1).to(torch.int32)).to(torch.float32).mean())

        # bench_latency's decision: fused == composed == packed == the plain version
        for name, (d, c) in lat.items():
            if not (torch.equal(d.cpu(), lat_want[0]) and torch.equal(c.cpu(), lat_want[1])):
                raise AssertionError(f"bench_latency decision: {name} differs from the plain version")
        # the obstacle example on the card against the same flow on the CPU
        for key in ("dec", "cnt"):
            self._note("bayes_decide", _int_err(obstacle[key].cpu(), obstacle_want[key]))
        self._note("fusion_map", _float_err(obstacle["fused"].cpu(), obstacle_want["fused"]))

        self._op_p = p
        self.say(f"operator path: paper-bayes-fusion M={m} K={k} {cfg.frames_per_batch}x"
                 f"{cfg.height}x{cfg.width} ({r} pixels) n_bits={n_bits}: fusion_map, fused "
                 f"bayes_decide and sne_encode -> pand_popcount -> argmax in {full_s:.3f} s "
                 f"(first calls); fused == composed on all {r} pixels; slices at pixels "
                 f"{list(starts)} equal to the plain versions; stochastic decision agrees with "
                 f"the analytic argmax on {agree * 100:.2f}% of pixels; launches "
                 f"{self.op_launches}")
        self.say(f"bench_latency decision ({LAT_DECISIONS} decisions, M=K=2, {LAT_BITS} bits): "
                 f"fused == composed == bayes_decide_packed == plain version")
        rates = obstacle["rates"]
        self.say("obstacle_fusion 64x64 night scene: detection rate / fp rate / confidence "
                 + "; ".join(f"{n} {v[0] * 100:.1f}% / {v[1] * 100:.2f}% / {v[2]:.2f}"
                             for n, v in rates.items())
                 + f"; stochastic (256 bits) vs analytic: mean abs err "
                 f"{obstacle['mean_abs_err']:.3f}, decision agreement "
                 f"{obstacle['agreement'] * 100:.1f}%; equal to the CPU flow")
        self.report["operators"] = {
            "launches": self.op_launches, "max_abs_err": self.op_err,
            "full_pixels": r, "full_first_call_s": full_s, "slice_starts": list(starts),
            "stochastic_vs_analytic_argmax_agreement": agree,
            "obstacle": {key: obstacle[key] for key in ("rates", "mean_abs_err", "agreement")},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }

    def _op_bound(self, name, m, px, k, n_bits):
        """(bound ms, what sets it, operations, bytes) of one launch."""
        w = n_bits // 32
        rate = self.int32_ops_per_s
        if name == "sne_encode":
            rows = m * px * k
            ops, nbytes = rows * (n_bits // 4) * OPS_PER_ENTROPY_WORD, 4 * rows * (1 + w)
        elif name == "pand_popcount":
            rows = px * k
            ops, nbytes = rows * w * (m + 1), 4 * rows * (m * w + 1)   # ANDs, popcount, add
        elif name == "bayes_decide":
            ops = m * px * k * (n_bits // 4) * OPS_PER_ENTROPY_WORD
            nbytes = 4 * (m * px * k + px * k + px)
        else:   # fusion_map: clip, log, add per input; sub, max, exp, add, divide per output
            ops, nbytes = 4 * m * px * k + 5 * px * k, 4 * (m * px * k + k + px * k)
            rate = F32_FLOPS_PER_S
        op_ms, byte_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), ops, nbytes

    def operator_timing(self):
        cfg = full_config()
        m, k, n_bits = cfg.modalities, cfg.classes, cfg.n_bits
        kd = rng.seed_words(OP_KEY)
        prior = torch.full((k,), 1.0 / k, device="cuda")
        logprior = log_prior(prior, m)
        table = {n: {} for n in ("sne_encode", "pand_popcount", "bayes_decide", "fusion_map")}
        for size, px in (("full", self._op_p.shape[1]), ("line", LINE_PIXELS)):
            ps = self._op_p if size == "full" else self._op_p[:, :px].contiguous()
            flat = ps.reshape(-1)
            words = sne_kernel.sne_encode_cuda(*kd, flat, n_bits=n_bits).view(m, px * k, -1)
            reps = 5 if size == "full" else 50
            kernel = {
                "sne_encode": lambda: sne_kernel.sne_encode_cuda(*kd, flat, n_bits=n_bits),
                "pand_popcount": lambda: pp_kernel.pand_popcount_cuda(words),
                "bayes_decide": lambda: bd_kernel.bayes_decide_cuda(*kd, ps, n_bits=n_bits),
                "fusion_map": lambda: fm_kernel.fusion_map_cuda(ps, prior),
            }
            plain = {   # the whole function on the card: entropy drawn, then the plain version
                "sne_encode": lambda: sne_encode_ref(flat, _entropy(OP_KEY, (flat.numel(),),
                                                                    n_bits, 0)),
                "pand_popcount": lambda: pand_popcount_ref(words),
                "bayes_decide": lambda: bayes_decide_ref(ps, _entropy(OP_KEY, tuple(ps.shape),
                                                                      n_bits, 0)),
                "fusion_map": lambda: fusion_map_ref(ps, prior),
            }
            for name in table:
                bound, by, ops, nbytes = self._op_bound(name, m, px, k, n_bits)
                row = {"pixels": px, "ms": _event_ms(kernel[name], reps), "bound_ms": bound,
                       "bound_by": by, "ops": ops, "bytes": nbytes,
                       "plain_ms": _event_ms(plain[name], 3, warmup=1) if size == "line" else None}
                if name == "fusion_map":
                    row["composed_ms"] = _event_ms(lambda: torch.softmax(
                        torch.log(ps.clamp(1e-9, 1.0)).sum(0) - logprior, -1), reps)
                table[name][size] = row
                plain_txt = "not measured (does not fit)" if row["plain_ms"] is None \
                    else f"{row['plain_ms']:.3f} ms"
                extra = f", composed torch {row['composed_ms']:.4f} ms" if "composed_ms" in row else ""
                self.say(f"{name} {size} ({px} pixels, M={m} K={k} n_bits={n_bits}): kernel "
                         f"{row['ms']:.4f} ms/launch, plain {plain_txt}, bound {bound:.4f} ms "
                         f"({by}){extra}")
            del words
        lat_p = torch.rand((2, LAT_DECISIONS, 2), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
        lat = {"fused": _event_ms(lambda: bayes_decide(OP_KEY, lat_p, LAT_BITS), 50),
               "composed": _event_ms(lambda: _composed(OP_KEY, lat_p, LAT_BITS), 50),
               "packed": _event_ms(lambda: bayes_decide_packed(OP_KEY, lat_p, LAT_BITS), 50)}
        self.say(f"bench_latency decision ({LAT_DECISIONS} decisions, M=K=2, {LAT_BITS} bits), "
                 f"ms per call through the entry points: fused {lat['fused']:.4f}, composed "
                 f"{lat['composed']:.4f}, bayes_decide_packed {lat['packed']:.4f}; fused is "
                 f"{lat['composed'] / lat['fused']:.2f}x the composition")
        self.report["operator_timing"] = table
        self.report["latency_decision_ms"] = lat

    # ---------------------------------------------------------- unfused lowering
    def _nm_note(self, name, got, want):
        err = _int_err(got, want)
        self.nm_err[name] = max(self.nm_err[name], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version: max abs err {err}")

    def unfused_kernels(self):
        """Each node_mux kernel against its plain version on the same inputs, on the card."""
        self.nm_err = {name: 0 for name in NM_KERNELS}
        gen = torch.Generator(device="cuda").manual_seed(31)
        kd = rng.seed_words(NM_KEY)
        half_steps = (2 * torch.arange(8, device="cuda") + 1) / 512
        # (parents, rows, n_bits, counter origin)
        binary = [(0, 333, 128, 0), (1, BATCH, N_BITS, 0), (2, BATCH, N_BITS, NM_WRAP),
                  (3, BATCH, N_BITS, 0), (3, 1000, N_BITS, NM_WRAP), (6, 300, 256, NM_WRAP)]
        for m, rows, n_bits, off in binary:
            cpt = torch.rand((rows, 1 << m), generator=gen, device="cuda")
            cpt.view(-1)[:8] = half_steps[: cpt.numel()]
            cpt[-1] = 1.0
            par = _rand_words(gen, (m, rows, n_bits // 32))
            self._nm_note("node_mux_gather",
                          nm_kernel.node_mux_gather_cuda(*kd, cpt, par, n_bits=n_bits, offset=off),
                          node_mux_gather_ref(cpt, _entropy(NM_KEY, (rows,), n_bits, off), par))
            self._nm_note("node_mux_rows",
                          nm_kernel.node_mux_rows_cuda(*kd, cpt, par, n_bits=n_bits, offset=off),
                          node_mux_ref(cpt, _entropy(NM_KEY, (rows, 1 << m), n_bits, off), par))
        # (cards, rows, n_bits, counter origin): obstacle-class's rgb_class, k-ary
        # roots (no parents), parents of card 3 (their planes spell digit 3)
        cat = [((4, 4, 2), BATCH, N_BITS, 0), ((3,), BATCH, N_BITS, NM_WRAP), ((4,), 257, 128, 0),
               ((3, 3, 2), 1000, N_BITS, NM_WRAP), ((2, 3, 2, 2), BATCH, 256, 0),
               ((5, 2, 2, 2, 2), 300, 256, NM_WRAP)]
        for cards, rows, n_bits, off in cat:
            k, pcards = cards[0], cards[1:]
            n_leaves = int(np.prod(pcards)) if pcards else 1
            levels = torch.randint(0, 257, (rows, n_leaves, k - 1), generator=gen, device="cuda")
            cdf = torch.sort(levels, dim=-1, descending=True).values.to(torch.int32)
            par = _rand_words(gen, (sum(bitops.value_bits(c) for c in pcards), rows, n_bits // 32))
            self._nm_note("node_mux_cat",
                          nm_kernel.node_mux_cat_cuda(*kd, cdf, par, cards=cards, n_bits=n_bits,
                                                      offset=off),
                          cat_gather_body(cdf, _entropy(NM_KEY, (rows,), n_bits, off), par, cards))
        torch.cuda.synchronize()
        print(f"node_mux: {len(binary)} gather and rows cases, {len(cat)} cat cases (0-6 "
              f"parents, k-ary roots, counter origins wrapping 2**32) equal to the plain "
              f"versions: max abs err {self.nm_err} (tolerance 0: packed words must match "
              f"exactly)", flush=True)

    def unfused_path(self):
        """The unfused lowering through its entry points, against device="cpu"."""
        cases = [(n, "unfused") for n in NAMES] + [(n, "shared") for n in NAMES]
        cases += [(n, "rows") for n in NAMES if by_name(n).max_card() == 2]
        cases += [("pedestrian-night", "fill"), ("obstacle-class", "fill")]
        key = prng.PRNGKey(23)
        ev = {n: analytic.sample_evidence(by_name(n), torch.Generator().manual_seed(11),
                                          BATCH).numpy() for n in NAMES}
        drain = {n: _evidence(by_name(n), UNFUSED_DRAIN, seed=19) for n in NAMES}
        plain, refs = {}, {}
        for name, mode in cases:
            net = compile_network(by_name(name), n_bits=N_BITS, device="cpu",
                                  **UNFUSED_MODES[mode])
            plain[name, mode] = net.decide(key, ev[name])
        for i, n in enumerate(NAMES):
            net = compile_network(by_name(n), n_bits=N_BITS, device="cpu", fused=False)
            d = FrameDriver(net, max_batch=MAX_BATCH, salt=500 + i)
            d.submit(drain[n])
            refs[n] = d.drain()
        torch.cuda.synchronize()
        nets = {(name, mode): compile_network(by_name(name), n_bits=N_BITS, device="cuda",
                                              **UNFUSED_MODES[mode]) for name, mode in cases}
        torch.cuda.synchronize()
        _reset_launches()                                    # the unfused path starts
        outs, drains = {}, {}
        # a compiled unfused program only launches: any wait on the stream raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name, mode in cases:
                outs[name, mode] = nets[name, mode].decide(key, ev[name])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, n in enumerate(NAMES):
            net = compile_network(by_name(n), n_bits=N_BITS, device="cuda", fused=False)
            sync = FrameDriver(net, max_batch=MAX_BATCH, salt=500 + i)
            sync.submit(drain[n])
            asyn = FrameDriver(net, max_batch=MAX_BATCH, salt=500 + i)
            asyn.submit(drain[n])
            drains[n] = (sync.drain(), asyn.drain_async())
        torch.cuda.synchronize()
        self.nm_launches = _launches()                       # the unfused path ends
        for name in NM_KERNELS + ("sne_encode",):
            if self.nm_launches[name] <= 0:
                raise AssertionError(f"the unfused path launched {name} 0 times")
        for case, got in outs.items():
            post, dec, acc = (t.cpu() for t in got)
            want = plain[case]
            if not (torch.equal(post, want[0]) and torch.equal(dec, want[1])
                    and torch.equal(acc, want[2])):
                raise AssertionError(f"{case}: the unfused program on the card differs "
                                     f"from device='cpu'")
            if not (bool(torch.isfinite(post).all()) and float(post.min()) >= 0
                    and float(post.max()) <= 1 and torch.equal(dec, posterior_argmax(post))):
                raise AssertionError(f"{case}: posterior not in [0, 1] or decisions not its argmax")
        for n in NAMES:
            for out in drains[n]:
                if sorted(out) != list(range(UNFUSED_DRAIN)):
                    raise AssertionError(f"{n}: unfused drain rids are not 0..{UNFUSED_DRAIN - 1}")
                for rid, (p, a) in out.items():
                    rp, ra = refs[n][rid]
                    if not np.array_equal(p, rp) or a != ra:
                        raise AssertionError(f"{n}: unfused driver rid {rid} differs from the "
                                             f"device='cpu' driver")
        # against the enumeration oracle: unfused, shared entropy, and the fused sweep
        zrows = {}
        for n in NAMES:
            exact = analytic.make_posterior_fn(by_name(n), dac_quantize=True,
                                               device="cuda")(ev[n])[0].cpu()
            fused = compile_network(by_name(n), n_bits=N_BITS, device="cuda").run(key, ev[n])
            runs = {"unfused": (outs[n, "unfused"][0], outs[n, "unfused"][2]),
                    "shared": (outs[n, "shared"][0], outs[n, "shared"][2]), "fused": fused}
            for mode, (post, acc) in runs.items():
                z, groups = _pooled_z(ev[n], post.cpu().numpy(), acc.cpu().numpy(),
                                      exact.numpy(), mode == "shared")
                zrows[f"{n}/{mode}"] = {"max_z": z, "groups": groups}
                if z >= 4.5:
                    raise AssertionError(f"{n} {mode}: posterior {z:.2f} sigma from the oracle")
        torch.cuda.synchronize()
        worst = max(zrows.items(), key=lambda kv: kv[1]["max_z"])
        self.say(f"unfused path: {len(cases)} programs at n_bits={N_BITS}, B={BATCH} "
                 f"(7 scenarios x fused=False / share_entropy=True, rows on the binary 4, fill "
                 f"on 2) equal to device='cpu', none waiting on the stream (sync debug mode "
                 f"'error'); 7 x sync + async unfused FrameDriver drains of "
                 f"{UNFUSED_DRAIN} frames equal rid for rid; unfused, shared and fused posteriors "
                 f"within 4.5 sigma of the oracle (largest {worst[1]['max_z']:.2f} at {worst[0]}); "
                 f"launches {self.nm_launches}")
        self.report["unfused_path"] = {"launches": self.nm_launches, "oracle_z": zrows,
                                       "programs": [f"{n}/{m}" for n, m in cases]}

    def _nm_bound(self, name, rows, n_leaves, k, planes, n_bits, hashed=None):
        """(bound ms, what sets it, operations, bytes) of one node_mux launch.

        One hash per entropy word the function needs -- ``hashed`` for
        row-encode (:func:`_selected_leaf_words`), one per 4 stream bits
        otherwise -- and one compare per stream bit and level.
        """
        w = n_bits // 32
        words = rows * w * 8
        hashed = words if hashed is None else hashed
        ops = hashed * (OPS_PER_ENTROPY_WORD - 4) + words * 4 * (k - 1)
        table = rows * n_leaves * 4 * (k - 1)                      # cpt or cdf rows
        nbytes = table + 4 * rows * w * (planes + bitops.value_bits(k))
        op_ms = ops / self.int32_ops_per_s * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), ops, nbytes

    def unfused_timing(self):
        kd = rng.seed_words(NM_KEY)
        gen = torch.Generator(device="cuda").manual_seed(41)
        nodes = {"node_mux_gather": ("intersection", "rgb_cross"),
                 "node_mux_rows": ("intersection", "rgb_cross"),
                 "node_mux_cat": ("obstacle-class", "rgb_class")}
        table = {name: {} for name in NM_KERNELS}
        w = N_BITS // 32
        for b in (BATCH, NM_BIG):
            for name, (scen, node) in nodes.items():
                tab, pcards, card = _node_table(scen, node, b)
                planes = sum(bitops.value_bits(c) for c in pcards)
                par = _rand_words(gen, (planes, b, w))
                n_leaves = tab.shape[1]
                kernel, plain = _nm_calls(name, kd, tab, par, (card,) + pcards, b, n_leaves)
                hashed = _selected_leaf_words(par) if name == "node_mux_rows" else None
                bound, by, ops, nbytes = self._nm_bound(name, b, n_leaves, card, planes, N_BITS,
                                                        hashed)
                row = {"rows": b, "node": f"{scen}/{node}", "ms": _event_ms(kernel, 50),
                       "bound_ms": bound, "bound_by": by, "ops": ops, "bytes": nbytes,
                       "hashed_words": hashed or b * w * 8,
                       "kernel_hashed_words": b * w * 8 * (n_leaves if hashed else 1),
                       "plain_ms": _event_ms(plain, 3, warmup=1) if b == BATCH else None}
                table[name][b] = row
                plain_txt = "not measured (B=1024 only)" if row["plain_ms"] is None \
                    else f"{row['plain_ms']:.3f} ms"
                self.say(f"{name} {scen}/{node} B={b} n_bits={N_BITS}: kernel {row['ms']:.4f} "
                         f"ms/launch, plain {plain_txt}, bound {bound:.4f} ms ({by}; "
                         f"{row['hashed_words']} entropy words needed, the kernel hashes "
                         f"{row['kernel_hashed_words']})")
                del par, tab
        per_run, run_ms, dispatch_ms = {}, {}, {}
        key = prng.PRNGKey(29)
        for n in NAMES:
            spec = by_name(n)
            ev = _evidence(spec, BATCH, seed=3)
            nets = {mode: compile_network(spec, n_bits=N_BITS, device="cuda", **kw)
                    for mode, kw in (("unfused", dict(fused=False)),
                                     ("shared", dict(share_entropy=True)), ("fused", {}),
                                     ("rows", dict(mux_mode="rows")))
                    if mode != "rows" or spec.max_card() == 2}
            per_run[n] = {}
            for mode in ("unfused", "rows"):
                if mode in nets:
                    nets[mode].run(key, ev)
                    torch.cuda.synchronize()
                    _reset_launches()
                    nets[mode].run(key, ev)
                    torch.cuda.synchronize()
                    per_run[n][mode] = {k: v for k, v in _launches().items() if v}
            run_ms[n], dispatch_ms[n] = {}, {}
            for mode, net in nets.items():
                net.run(key, ev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    net.run(key, ev)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                run_ms[n][mode] = (time.perf_counter() - t0) / 10 * 1e3
                dispatch_ms[n][mode] = (t1 - t0) / 10 * 1e3
            self.say(f"{n} B={BATCH} n_bits={N_BITS}: ms per run (wall, synchronised) "
                     + ", ".join(f"{m} {v:.3f}" for m, v in run_ms[n].items())
                     + "; host dispatch "
                     + ", ".join(f"{m} {v:.3f}" for m, v in dispatch_ms[n].items())
                     + f"; unfused/fused {run_ms[n]['unfused'] / run_ms[n]['fused']:.1f}x; "
                     f"launches per unfused run {per_run[n]}")
        self.report["unfused_timing"] = {"kernels": table, "launches_per_run": per_run,
                                         "run_ms": run_ms, "dispatch_ms": dispatch_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    s = Smoke()
    s.phase("device", s.device)
    s.phase("build", s.build)
    if "build" not in s.failures:
        s.phase("kernels", s.kernels)
        s.phase("main_path", s.main_path)
        s.phase("timing", s.timing)
        s.phase("operators", s.operators)
        if "operators" not in s.failures:
            s.phase("operator_timing", s.operator_timing)
        s.phase("unfused_kernels", s.unfused_kernels)
        if "unfused_kernels" not in s.failures:
            s.phase("unfused_path", s.unfused_path)
        if "unfused_path" not in s.failures:
            s.phase("unfused_timing", s.unfused_timing)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(s.report, indent=1, default=str))
    if s.failures:
        print(f"chip_smoke: FAILED phases: {', '.join(s.failures)}", file=sys.stderr)
        return 1
    t = s.report["net_sweep"][TIMED_SCENARIO]
    kernels = {"kernels": [{
        "name": "net_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/net_sweep/csrc/net_sweep.cu",
        "replaces": REPLACES["net_sweep"],
        "launches": s.launches,
        "max_abs_err": s.max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "at": f"{TIMED_SCENARIO} B={BATCH} n_bits={N_BITS}",
    }]}
    for name, sizes in s.report["operator_timing"].items():
        line, full = sizes["line"], sizes["full"]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": s.op_launches[name],
            "max_abs_err": s.op_err[name], "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": None,   # no single PyTorch call computes it
            "at": f"paper-bayes-fusion M=2 K=16 n_bits=128, first {LINE_PIXELS} pixels",
            "full_ms": full["ms"], "full_bound_ms": full["bound_ms"],
        }
        if name == "fusion_map":
            entry["composed_ms"] = line["composed_ms"]
            entry["full_composed_ms"] = full["composed_ms"]
        kernels["kernels"].append(entry)
    for name, sizes in s.report["unfused_timing"]["kernels"].items():
        row, big = sizes[BATCH], sizes[NM_BIG]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/node_mux/csrc/node_mux.cu",
            "replaces": REPLACES[name], "launches": s.nm_launches[name],
            "max_abs_err": s.nm_err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,   # no PyTorch call computes it
            "at": f"{row['node']} B={BATCH} n_bits={N_BITS}",
            "ms_65536": big["ms"], "bound_ms_65536": big["bound_ms"],
        })
    print(s.name_power)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
