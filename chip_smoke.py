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

Before the last line it prints the ``nvidia-smi`` name/power-limit line and a
``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  The full report also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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

from repro_torch.bayesnet import (  # noqa: E402
    SCENARIOS,
    FrameDriver,
    NoiseModel,
    by_name,
    compile_network,
    posterior_argmax,
    sweep_plan,
)
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.net_sweep import kernel as net_sweep_kernel  # noqa: E402
from repro_torch.kernels.net_sweep import record_program, sweep_tile  # noqa: E402
from repro_torch.obs import PAPER_BUDGET_MS  # noqa: E402

NAMES = sorted(SCENARIOS)
N_BITS, BATCH = 4096, 1024            # compile_network's default width, the README's batch
DRAIN_FRAMES, MAX_BATCH = 4096, 256
KD = (0x9E3779B9, 0x7F4A7C15)
INT32_LANES_PER_SM = 64               # Hopper SM, per clock (NVIDIA H100 white paper)
HBM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
TIMED_SCENARIO = "intersection"       # the largest network: the kernels line's numbers


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
        t0 = time.perf_counter()
        path, log = backend.build_library(net_sweep_kernel.SOURCE)
        print(f"built {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
        print(log.strip(), flush=True)
        net_sweep_kernel.library()
        self.report["build_log"] = log

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
        net_sweep_kernel.net_sweep_cuda.launches = 0          # the main path starts
        outs = {}
        for i, n in enumerate(NAMES):
            sync = FrameDriver(nets[n], max_batch=MAX_BATCH, salt=100 + i)
            sync.submit(frames[n])
            asyn = FrameDriver(nets[n], max_batch=MAX_BATCH, salt=100 + i)
            asyn.submit(frames[n])
            outs[n] = (sync.drain(), asyn.drain_async(),
                       [t.cpu() for t in nets[n].decide(prng.PRNGKey(5), frames[n][:BATCH])])
        torch.cuda.synchronize()
        self.launches = net_sweep_kernel.net_sweep_cuda.launches   # the main path ends
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
        self.report["main_path"] = {"launches": self.launches,
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
        "replaces": "src/repro/kernels/net_sweep/kernel.py:38",
        "launches": s.launches,
        "max_abs_err": s.max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "at": f"{TIMED_SCENARIO} B={BATCH} n_bits={N_BITS}",
    }]}
    print(s.name_power)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
