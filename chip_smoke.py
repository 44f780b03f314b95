#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases (any failure makes the script exit non-zero without the result line):

1. device  -- the card's name, power limit and max SM clock (``nvidia-smi``).
2. build   -- ``nvcc`` builds, all started together, every kernel library of
              the paths from ``src/`` -- the operator and node_mux sources and
              one generated ``net_sweep`` program per plan the run launches
              (``kernels/net_sweep/codegen.py``; the reliability and drift
              phases build their own plans' programs as they start) -- and
              prints ``-Xptxas -v``
              (registers, spills), the nvcc seconds of each program and its
              integer instructions in ``cuobjdump -sass`` (for the two SNE
              kernels also per copy of the hash, beside the counted least).
3. kernels -- each generated ``net_sweep`` against its plain torch version on
              the card, bit for bit: all 7 scenarios at n_bits=4096, B=1024,
              decide off and on; nominal noise with 3 drift epochs; a
              frame0/total_frames slice whose counters wrap 2**32; n_bits=128;
              and the wide network (a 7-parent binary node and a 9-plane
              k-ary node).
4. main    -- the port's main path through its entry points: per scenario
              ``compile_network(spec, n_bits=4096, device="cuda")`` and a
              ``FrameDriver(max_batch=256)`` draining 4096 seeded frames in
              sync and in async mode, held per rid against a driver whose
              network was built on the plain version (``device="cpu"``);
              ``decide`` on the card against ``decide`` on the CPU.  Launch
              counts are reset just before and read just after, and no
              ``net_sweep`` program is built in between.
5. timing  -- ``net_sweep`` per scenario at B=1024 and at B=256 (the drain's
              bucket): device time per launch (``torch.profiler``) and time per
              back-to-back call (CUDA events, which the host's launch cost sets
              once the kernel is shorter), beside the integer-work bound (the
              gate program's LOP3-aware count, or the SASS count where that
              is lower, with logic, shifts and compares on the 64 ALU lanes
              of an SM and multiplies and adds free to use all 128); frames per
              second of the async drain; single-frame ``decide`` latency
              p50/p99 at n_bits 128 and 4096.
6. binary_timing -- the binary gather and row encode at 1 to 6 parents
              (B=1024 and 65,536), beside the gather's pattern-table route
              (held equal to the gather first).  It runs early: once the
              unfused and wide phases have run, torch.profiler sessions on
              the H100 drop a few launches (PERF.md).
7. drain_trace -- ``torch.profiler`` over one async drain (intersection, 4096
              frames, max_batch=256): the device's busy share of the window
              and kernel time by name.
8. router  -- the multi-tenant ``BayesRouter`` at its own defaults (n_bits=4096,
              max_batch=256, ``RouterPolicy()``: rungs of 4096/1024/256 bits)
              over the 7 scenario tenants, submitted round-robin in chunks of
              4: a 7 x 256-frame serve on the card equal rid for rid (status,
              posterior, accepted, level) to a ``device="cpu"`` router and per
              tenant to a standalone card ``FrameDriver`` with
              ``salt=tenant_salt(name)``, launch counts reset just before and
              read just after (``net_sweep`` only, no program built); seeded
              5% launch-fault chaos (bench_serve's ``CHAOS``, max_batch=8),
              card equal to CPU; an overload serve of 7 x 1024 frames (the
              timed overload round's shape, every frame DEGRADED at rung 1,
              1024 bits) card equal to CPU, launch counts reset and read
              around it; the timed serve -- a warm-up round, then 3
              rounds each of nominal (7 x 512 frames), overload (7 x 1024,
              which walks the ladder to rung 1) and chaos (7 x 512) at the
              default 1 s deadline, failing on a lost frame or a ``net_sweep``
              build, reporting frames/s (the best round's, and all frames
              over all rounds' wall time), the status census, the deadline hit
              rate and the device's busy share of one traced nominal round;
              a forced recalibration of a noisy tenant (card equal to CPU, one
              swap, the swap's wall time and its twin's nvcc seconds); and
              ``calibration_report`` on the card equal to the CPU.
9. reliability -- bench_reliability's flows (``benchmarks/bench_reliability.py``,
              its sizes copied here), each run on the CPU, then its plans'
              ``net_sweep`` programs built (one nvcc each, all started
              together; the count and nvcc seconds printed), then run on the
              card with launch counts reset just before and read just after
              and no program built in between, and held equal to the CPU run:
              posteriors, accepted counts, decisions, flip rates,
              ``ReliabilityStats`` (but the host-clocked ``slow_launches``)
              and every frame's retry report.  The 7 scenarios' flip rate
              against the clean DAC-quantised oracle over 512 frames at noise
              scales 0, 0.5, 1 and 2 x nominal (1024 bits) and at 256, 1024 and
              4096 bits (nominal), the last at most 0.15; the retry race on
              obstacle-detection, lane-change and intersection-cat (256 bits,
              ``RetryPolicy(0.9, 2 retries, 4x, 16384)`` against a flat driver
              at the retry's mean bits rounded up to 32, both against the
              perturbed oracle) in sync and async drains: retry no worse than
              flat at a bit overhead of at most 8x.
10. drift  -- bench_drift's flows, run and held as ``reliability``'s, with the
              drift monitor's per-launch snapshots held too: the aging race of
              the 7 scenarios (``NoiseModel(seed=4, wear_tau=4)``, 1024 bits,
              128 frames, 7 launches 2 cycles apart, the open arm on the aged
              plan, the closed arm refit by ``compensated_program`` every other
              launch, the final cycle averaged over 8 launches): closed at most
              0.008 worse than open in each, strictly better in at least 5;
              the hot swap (pedestrian-night, 16 frames, max_batch 4): two
              launches per driver queued behind ``torch.cuda._sleep``, their
              events incomplete when ``swap_net`` switches to
              ``recalibrated_network(net, cycle=8)`` (built beforehand), no
              frame lost and the 8 pre-swap frames equal to a never-swapped
              twin's; and ``tests/test_torch_drift.py``'s three drift-monitor
              cases (256 bits, max_batch 4, 40 frames) in sync and async.
11. paper_layer -- the paper-figure layer (``core/*``) and the four examples
              (``repro_torch.examples``) at the reference benchmarks' own
              sizes, each flow on the CPU and then on the card, held by
              ``PAPER_RULES`` (streams, counts and ratios exact; the float
              draws and curves within stated tolerances): Fig 1/S4 (OU path
              of 20,000 cycles, 1000 devices, the OU fit, 100,000 endurance
              cycles), Fig 2b/2c/2e (six transfer-curve points at 2**14 bits,
              AND in 3 modes and MUX over 50 keys at 100 bits, precision at
              100/1000/10,000 bits), Table S1 (AND/OR/XOR x 3 modes, MUX, 2**14
              bits), Fig 3 (inference over 100 keys and a 12-point grid at 100
              bits, both correlation matrices at 2**14, the marginal variant,
              the Fig S8 motifs at 2**13, 4096 batched inferences at 128 bits),
              Fig 4 (30 scenes through fusion_map, detection_fusion of 64
              boxes at 4096 bits, bayes_fusion at paper-bayes-fusion's widths
              on a 4096-pixel tile under both entropy generators),
              encode_via_device (1024 streams x 1024 bits; bits compared
              outside a margin), then quickstart, route_planning, scene_graph
              and obstacle_fusion at their scripts' sizes.  Per flow: seconds
              on the card and launches per kernel; then the throughput model
              beside the batched operator's measured rate.
12. lm_serve -- the LM serving path (configs, the attention-only decoder, the
              ``ServeEngine`` with the Bayes gate).  phi3-mini-3.8b at its
              published config, every layer, random weights from
              ``PRNGKey(0)`` made on the card: init seconds and peak memory;
              decode after prefill against the teacher-forced forward
              (``tests/models/test_smoke_archs.py``'s tolerances); 6 requests of
              8-12 prompt tokens, 16 new tokens each, on 4 slots (two admitted
              mid-flight) with the stochastic gate at 256 bits, counts reset just
              before and read just after: prefill and decode ms (CUDA events),
              tokens/s, ``bayes_decide`` launches (one per step) and the share of
              emissions that cleared the gate; every step's gate input through
              ``bayes_decide`` bit-equal to its plain version, and its device
              time at that shape beside its bound.  Then card against CPU: phi3
              at full width cut to 2 layers (weights copied from the card; the
              CPU's greedy tokens forced on both; logits within the stated
              tolerances, the gate on the CPU's logits bit-equal on both), the
              five archs of the slice at their smoke configs (forward, prefill,
              decode, gate), ``repro_torch.launch.serve`` for phi3 with the
              stochastic gate, and ``examples.serve_lm.run`` card against CPU
              (tokens held while the fused top-2 gap clears 1e-2).
13. lm_blocks -- the other block kinds (MoE, MLA, RG-LRU, xLSTM, enc-dec, the
              MTP head).  recurrentgemma-2b and xlstm-350m at their published
              configs, every layer, served as lm_serve serves phi3 (init s and
              peak memory, decode after prefill against the teacher-forced
              forward, 6 requests through ``ServeEngine`` with the stochastic
              gate, counts reset just before and read just after, the gate
              equal to its plain version at every step); seamless-m4t-large-v2
              at its published config, a prefill of frames and tokens and 8
              greedy decode steps through ``api`` (the engine serves no
              frames, in the reference neither); llama4-scout at full width
              cut to 4 layers and deepseek-v3 at full width cut to 2 layers
              with its MTP head (``reduced``: the whole configs do not fit one
              card): decode after prefill against the forward with the expert
              routing of the two runs compared first, the sort dispatch
              against the dense impl on a layer's own weights, and deepseek's
              main and MTP heads fused by ``fuse_posteriors_stochastic`` (one
              ``bayes_decide`` launch, equal to its plain version; its device
              time beside its bound).  Then card against CPU: recurrentgemma at
              full width cut to 5 layers, xlstm-350m whole, seamless cut to 2 +
              2 layers, and the five archs' smoke configs, routing first.
              Each model is freed before the next.
14. lm_train -- the training stack (AdamW, the data pipeline, checkpoints,
              ``TrainLoop``, the train launcher and example).  phi3-mini-3.8b at
              its published config, every layer, random weights from
              ``PRNGKey(0)`` made on the card, trained 6 steps through
              ``TrainLoop`` with the launcher's data and optimizer settings
              (batch 8 x 128, lr 1e-3) and no checkpoint: init seconds, peak
              memory, every step's loss and grad norm (finite), forward+backward
              and optimizer ms per step (CUDA events, median of steps 2-5),
              tokens/s and model FLOPs utilization (6 N tokens at 989 TFLOP/s,
              the recompute not counted).  Then the in-place restore at that
              size, into the live state: the params and master after 6 steps
              saved (30.6 GB; the whole state's 61 GB would pass the machine's
              disk allowance; stall and write s), a 7th step, the two restored
              (s, and the card memory it adds: at most one float32 leaf; every
              tensor's bit sums equal to the saved ones) and the step replayed
              (the same loss).  Then at full width cut to 2 layers:
              one ``make_train_step`` on the card against the CPU (weights
              copied from the card; loss, every new param, the master, m and
              v within the stated tolerances), 2 microbatches against 1 on the
              card (the float32 promotion of the reference), and the checkpoint
              cycle under ``torch.use_deterministic_algorithms`` (a loop stopped
              at step 2 and resumed to 4 equal bit for bit to an uninterrupted
              one; the save's stall, the async write and the restore in
              seconds and the card memory it adds, disk and memory free).  Then the ten archs' smoke
              configs, one train step card against CPU with MoE routing
              compared first (where a near-tie flips, the step again on the
              rows that route alike, and every check held there; should those
              differ too, the loss, m and v and every param within 2 lr); ``repro_torch.launch.train --smoke`` and
              ``examples.train_lm.run`` card against CPU (every step's loss),
              and the example on the card at its script's 60 steps, whose loss
              must fall.
15. multi_device -- the multi-device half on ``torch.distributed``: a world
              of 2 ranks sharing the one card over gloo (``cpu:gloo,cuda:gloo``;
              NCCL takes no two ranks on one GPU), spawned with a timeout, a
              failing rank failing the phase.  The 7 scenarios at B=1024,
              n_bits=4096 through ``compile_network(devices=2)``, run and
              decide bit-equal to the single launch of the same plan, launch
              counts reset just before and read just after (one ``net_sweep``
              launch per rank per call), an odd batch (unsharded), and
              frames/s sharded against single; ``examples.sharded_sweep.run``
              at its own size; llama4-scout's MoE layer at its published
              width (16 experts of 8192, top-1, a shared expert; 4.03 GB of
              expert leaves) expert parallel on a (1, 2) mesh against the local
              path, expert ids first; the GPipe pipeline at d=3072 against the
              unpipelined oracle; ``compressed_mean`` of a 3072 x 3072
              gradient bit for bit.  Then the sharded loss of phi3-mini-3.8b at
              full width cut to 2 layers (DTensor params placed by
              ``param_shardings``) against the unsharded loss at 1 rank over
              NCCL: gloo kills the process in the functional all_gather that
              DTensor's Shard -> Replicate uses on CUDA tensors.  Seconds and
              peak GB per rank per step.  Two ranks on one card measure the
              logic and gloo's host copies, not NVLink.
16. dryrun -- the H100-cluster dry run (``repro_torch.launch.dryrun``), its
              processes under a timeout: (a) phi3-mini-3.8b x ``train_4k`` on
              both production meshes (``h100x32x8``, ``h100x2x16x8``),
              llama4-scout x ``decode_32k``, deepseek-v3 x ``prefill_32k``
              and ``train_4k``, recurrentgemma-2b x ``prefill_32k``,
              xlstm-350m x ``train_4k`` and ``paper-bayes-fusion`` x
              ``train_4k``, each ``python -m repro_torch.launch.dryrun`` on a
              fake world of 256 ranks under ``FakeTensorMode`` (xlstm's,
              5-10 minutes on one CPU core, started with the script): the
              three roofline terms, the bottleneck, peak GB per GPU and trace
              seconds, any ``ok: false`` failing the phase, and a cell of
              ``DRYRUN_FIT`` (phi3 ``train_4k``, deepseek-v3 ``train_4k``,
              recurrentgemma-2b ``prefill_32k``, on ``h100x32x8``) failing it
              above 80 GB per GPU;
              the trace seconds of one sLSTM layer at ``train_4k``'s per-GPU
              batch, 1024 steps (``SLSTM_TRACE``); (b) one rank, no
              mesh: a phi3 train step at full width cut to 2 layers at
              lm_train's batch (8 x 128) counted on real CUDA tensors and
              counted fake -- FLOPs and bytes equal, the fake peak within 10 %
              of ``torch.cuda.max_memory_allocated`` -- and a second step timed
              with CUDA events beside the roofline's terms; (c) whole phi3 at
              that batch on one GPU, counted fake: the memory terms of the
              forward+backward and of the optimizer beside lm_train's measured
              times.
17. operators -- the paper's fusion operators.  Each of ``sne_encode``,
              ``pand_popcount``, ``bayes_decide`` and ``fusion_map`` against
              its plain torch version on the card (bit for bit; fusion_map
              within atol 2e-6, rtol 1e-5) at M 1..3, K 1, 2, 8, 16 and 33,
              one row, row counts off the block grid, the unfused root
              (1024 rows of 4096 bits), the bench_latency and bayes_head
              shapes, and counter origins that wrap 2**32; and
              ``fusion_map`` at K 2, 3, 4, 16, 17, 64 and 130 x M 1..3 x R 1,
              7, 4096 and 65,537, with a prior and with none, each shape on
              the kernel its K picks (lanes per row for K a multiple of 4 up
              to 128, whole rows per lane for K = 2, the shared-memory tile
              otherwise).  Then
              the operator path through its entry points, counts reset just
              before and read just after: the full ``paper-bayes-fusion``
              batch (M=2, K=16, 8 frames of 1080x1920, 128 bits) through
              ``fusion_map``, the fused ``bayes_decide`` and the composed
              ``sne_encode`` -> ``pand_popcount`` -> argmax, which must agree
              on every pixel, with slices of rows held against the plain
              versions at their counter origins; the ``bench_latency``
              decision (4096 decisions, M=K=2, 128 bits: fused, composed,
              ``bayes_decide_packed``); and the ``obstacle_fusion`` example
              flow at 64x64 (``examples.obstacle_fusion.run``).
18. operator_timing -- device time per launch (``torch.profiler``, the L2
              flushed before each launch) and per back-to-back call (CUDA
              events) of the four kernels at the full batch and at a
              65,536-pixel slice of it, beside their plain
              versions (slice only: the plain versions do not fit at full
              size), their bounds, and the composed torch expression for
              ``fusion_map``; then the encoders where a launch is small:
              ``sne_encode`` at the unfused root (1024 rows of 4096 bits) and
              the shared-entropy root (one row), ``bayes_decide`` at the
              ``bench_latency`` decision and a ``bayes_head`` batch; and a
              Fig 4 scene (64x64, M=2, K=2) through the whole
              ``ops.fusion_map`` call with no prior: launches per call (one),
              ms per call by CUDA events, the kernel's device time (the L2
              flushed).  The SNE
              bound counts the shared body's least integer work per entropy
              word, logic on the 64 ALU lanes of an SM and multiplies and
              adds free to use all 128, as ``net_sweep``'s.
19. unfused_kernels -- the ``node_mux`` kernels against their plain versions
              on the card, bit for bit: gather and rows at 0 to 6 parents
              (per-row tables and shared rows holding thresholds 0, 128, 256
              and the half steps) and at 7 and 8 (the gather on the
              categorical kernel at k = 2, rows on its wide kernel), the
              categorical pattern-table kernel at 0 to 6 parent planes
              (per-row and shared tables; 6 binary parents at k = 2) and
              its wide path at 9 planes and at 17 parents, k-ary roots, and
              counter origins that wrap 2**32.
20. unfused_path -- the unfused lowering through its entry points at
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
21. wide_path -- the wide network through ``compile_network`` fused,
              ``fused=False``, ``share_entropy=True`` and ``mux_mode='rows'`` at
              n_bits=4096, B=1024, each ``decide`` bit-equal to
              ``device="cpu"``; counts reset just before and read just after,
              and each wide kernel must have launched.
22. unfused_timing -- device time per launch and per back-to-back call of the
              node_mux kernels at B=1024 and B=65,536 (n_bits=4096; the wide
              paths at B=256) beside their plain versions and bounds; launches
              of each kernel per unfused ``run`` of each scenario; wall time per
              1024-frame batch of the unfused, shared and fused programs.

Before the last line it prints the ``nvidia-smi`` name/power-limit line and a
``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  The full report also goes to
``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --phases binary_timing[,...]`` runs the device phase
and the named phases only, in their usual order, and prints their report as
the last line instead of the result lines.  A phase that reads what an
earlier one leaves needs that one named too.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))       # torch_wide_net: the wide network
# cuBLAS's workspace configuration that torch.use_deterministic_algorithms
# asks for (lm_train's resume check); read once, when cuBLAS first starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.bayesnet as tbn  # noqa: E402
from repro_torch.bayesnet import analytic  # noqa: E402
from repro_torch.bayesnet import (  # noqa: E402
    SCENARIOS,
    FrameDriver,
    NoiseModel,
    RetryPolicy,
    by_name,
    compile_network,
    flip_rate,
    posterior_argmax,
    sweep_plan,
)
from repro_torch.bayesnet.reliability import TERMINAL_STATUSES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.paper_bayes import full_config  # noqa: E402
from repro_torch.core import bitops, prng, rng  # noqa: E402
from repro_torch.core import correlation, fusion, graph, inference, latency, logic, sne  # noqa: E402
from repro_torch.core import device as memristor  # noqa: E402
from repro_torch.data import detection  # noqa: E402
from repro_torch.examples import obstacle_fusion, quickstart, route_planning, scene_graph  # noqa: E402
from repro_torch.examples import serve_lm, train_lm  # noqa: E402
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
    binary_cat_table,
    cat_gather_body,
    cat_table,
    node_mux_gather_ref,
    node_mux_ref,
)
from repro_torch.kernels.pand_popcount import kernel as pp_kernel  # noqa: E402
from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref  # noqa: E402
from repro_torch.kernels.sne_encode import kernel as sne_kernel  # noqa: E402
from repro_torch.kernels.sne_encode.ref import sne_encode_ref  # noqa: E402
from repro_torch.distributed.fault import LaunchFaultInjector  # noqa: E402
from repro_torch.obs import PAPER_BUDGET_MS  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
# the H100 SXM5 data sheet's HBM rate and dense bf16 peak (repro_torch/launch/mesh.py)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_PEAK_FLOPS  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import TrainConfig, TrainLoop, make_train_step  # noqa: E402
from repro_torch.models import api, bayes_head, encdec, layers, moe, transformer  # noqa: E402
from repro_torch.serve import BayesRouter, EngineConfig, Request, RouterPolicy, ServeEngine, tenant_salt  # noqa: E402,E501
from repro_torch.serve import engine as engine_mod  # noqa: E402
from torch_wide_net import wide_spec  # noqa: E402

NAMES = sorted(SCENARIOS)
N_BITS, BATCH = 4096, 1024            # compile_network's default width, the README's batch
DRAIN_FRAMES, MAX_BATCH = 4096, 256
KD = (0x9E3779B9, 0x7F4A7C15)
# Hopper SM, per clock (NVIDIA H100 white paper): 4 sub-partitions, each
# with 16 INT32 lanes and one 32-lane warp instruction dispatched per clock;
# integer multiplies and adds may also run on the FP32/FMA pipe.
INT32_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
# SASS opcodes of integer work: only the ALU runs the first set, the FMA pipe
# may also take the second
SASS_ALU = {"LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL", "POPC", "PRMT", "FLO",
            "BREV", "BMSK", "IMNMX", "IABS"}
SASS_MULADD = {"IMAD", "IADD3", "IADD", "LEA", "VIADD", "IMUL"}
TIMED_SCENARIO = "intersection"       # the largest network: the kernels line's numbers
F32_FLOPS_PER_S = 67e12               # H100 SXM float32 outside the tensor cores (data sheet)
# The least integer work per entropy word of sne_encode / bayes_decide (their
# shared body, kernels/sne_encode/csrc/sne_body.h), counted as net_sweep's: a
# cone of logic over at most three values is one LOP3.  On the ALU alone (11):
# the hash's 3 shifts and 5 XORs (a word's 8 counters share the first step,
# each XORing it with its place in the word; the first round's last shift-XOR
# and the second's first cancel, leaving one XOR with the second key), the
# compare's OR and one combining cone (at a row's threshold class; the kernels
# take one more to serve both classes without a branch), and the pack's funnel
# shift.  Multiply or add (6, either pipe): the hash's 4 multiplies, the
# compare's subtract, the pack's multiply.
SNE_ALU_OPS, SNE_MULADD_OPS = 11, 6
# node_mux's bound per entropy word it needs: the hash's 18 operations, all
# charged to the ALU lanes
NM_HASH_OPS = 18
SNE_HASH_CONST = "0x7feb352d"         # each hash multiplies by it twice: counts hash copies in SASS
OP_KEY = np.array([0x2545F497, 0x7F4A7C15], np.uint32)      # seed words of the operator runs
OP_SLICE = 4096                       # pixels per slice held against the plain versions
LINE_PIXELS = 65536                   # the kernels line: a slice of the full batch
LAT_DECISIONS, LAT_BITS = 4096, 128   # bench_latency's decision workload (M = K = 2)
# a bayes_head batch: 64 tokens, its top 8 classes, two modalities, 256 bits
HEAD_TOKENS, HEAD_CLASSES, HEAD_BITS = 64, 8, 256
# (kernel, name, (M, R, K, n_bits)): the encoders where a launch is small --
# the unfused path's binary root (1024 rows of 4096 bits) and its shared-entropy
# root (one row), bench_latency's decision and a bayes_head batch
ENCODER_SHAPES = (("sne_encode", "unfused_root", (1, BATCH, 1, N_BITS)),
                  ("sne_encode", "shared_root", (1, 1, 1, N_BITS)),
                  ("bayes_decide", "latency", (2, LAT_DECISIONS, 2, LAT_BITS)),
                  ("bayes_decide", "head", (2, HEAD_TOKENS, HEAD_CLASSES, HEAD_BITS)))
FM_ATOL, FM_RTOL = 2e-6, 1e-5         # fusion_map: card logf/expf vs torch log/exp
# fusion_map's shapes held in the operators phase: K -> the kernel it takes
# (lanes per row for K a multiple of 4 up to 128, whole rows per lane for
# K = 2, the shared-memory tile otherwise), at each M of FM_MODS and R of FM_ROWS
FM_ROUTE = {2: "pair", 3: "tile", 4: "group", 16: "group", 17: "tile", 64: "group", 130: "tile"}
FM_MODS, FM_ROWS = (1, 2, 3), (1, 7, 4096, 65537)
FIG4_PIXELS = 64 * 64                 # a Fig 4 scene (M = 2, K = 2) through ops.fusion_map
NM_KEY = np.array([0x85EBCA6B, 0x3C6EF372], np.uint32)     # seed words of the node_mux checks
NM_WRAP = 2**32 - 5000                # a counter origin whose draws wrap 2**32
NM_BIG = 65536                        # rows where the launch no longer dominates (32 MB out)
NM_KERNELS = ("node_mux_gather", "node_mux_rows", "node_mux_cat")
UNFUSED_DRAIN = 1024                  # frames per unfused driver drain
# the unfused path's programs: mode -> compile_network keywords
UNFUSED_MODES = {"unfused": dict(fused=False), "shared": dict(share_entropy=True),
                 "rows": dict(mux_mode="rows"), "fill": dict(estimator="fill")}
LIBRARIES = {   # kernel sources built as they are; net_sweep is built per program
    "sne_encode": sne_kernel, "pand_popcount": pp_kernel, "bayes_decide": bd_kernel,
    "fusion_map": fm_kernel, "node_mux": nm_kernel,
}
LAUNCHERS = {
    "net_sweep": net_sweep_kernel.net_sweep_cuda, "sne_encode": sne_kernel.sne_encode_cuda,
    "pand_popcount": pp_kernel.pand_popcount_cuda, "bayes_decide": bd_kernel.bayes_decide_cuda,
    "fusion_map": fm_kernel.fusion_map_cuda,
    "node_mux_gather": nm_kernel.node_mux_gather_cuda,
    "node_mux_rows": nm_kernel.node_mux_rows_cuda,
    "node_mux_cat": nm_kernel.node_mux_cat_cuda,
    "node_mux_rows_wide": nm_kernel.node_mux_rows_wide_cuda,
    "node_mux_cat_wide": nm_kernel.node_mux_cat_wide_cuda,
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
    "node_mux_rows_wide": "src/repro/kernels/node_mux/kernel.py:37",
    "node_mux_cat_wide": "src/repro/kernels/node_mux/kernel.py:86",
}
WIDE_KERNELS = ("node_mux_rows_wide", "node_mux_cat_wide")
# parents -> the binary node timed per parent count: intersection's 1-, 2- and
# 3-parent nodes, and the hub of wide_spec(m) for 4 to 6 parents
BINARY_NODES = {1: ("intersection", "horn"), 2: ("intersection", "radar_cross"),
                3: ("intersection", "rgb_cross"), 4: ("wide-4", "hub"), 5: ("wide-5", "hub"),
                6: ("wide-6", "hub")}
# CPT values whose thresholds are 0, 256 (also clipped from outside [0, 1]), 128
# and the half steps (2k+1)/512, which round to even
EDGE_P = (0.0, 1.0, 0.5, 1 / 512, 3 / 512, 255 / 512, 257 / 512, 511 / 512, 1.5, -0.25)
WIDE_BATCH = 256                      # rows of the wide kernels' timing (their plain versions fit)
NOISY = ("intersection", "intersection-cat")   # the drift-epoch checks: nominal noise, 3 epochs
# the router phase, at the router's own defaults (n_bits=4096, max_batch=256,
# RouterPolicy(): capacity 4096, degrade step 4 -- rungs of 4096/1024/256 bits)
ROUTER_KEY = prng.PRNGKey(42)
ROUTER_CHUNK = 4                      # round-robin submission granularity (bench_serve's)
ROUTER_PARITY_FRAMES = 256            # per tenant, card against CPU
ROUTER_OVERLOAD_FRAMES = 1024         # per tenant: 7,168 queued frames, rung 1 for all
ROUTER_CHAOS_FRAMES, ROUTER_CHAOS_BATCH = 64, 8
ROUTER_LONG_MS = 600_000.0            # a deadline no run comes near: statuses not timed
ROUTER_ROUNDS = 3
# timed rounds: mode -> frames per tenant (7 x 512 = 3,584 frames stay under the
# 4,096 capacity; 7 x 1024 = 7,168 walk the ladder to rung 1)
ROUTER_MODES = {"nominal": 512, "overload": 1024, "chaos": 512}
CHAOS = dict(seed=7, p_drop=0.02, p_stall=0.01, p_corrupt=0.02, stall_ms=2.0)  # bench_serve's
FAST = dict(backoff_base_s=1e-4, backoff_cap_s=2e-3, breaker_cooldown_s=0.01)
RECAL_TENANT, RECAL_FRAMES = "pedestrian-night", 256


def _spec(name):
    if name in ("wide-4", "wide-5", "wide-6"):
        return wide_spec(tbn, int(name[5:]))
    return wide_spec(tbn, 7, n_cls=9) if name.startswith("wide") else by_name(name)


def _sass_counts(library, kernel, marker=None):
    """{mangled function: Counter of SASS opcodes} of the functions whose name
    holds ``kernel`` in one built library (``cuobjdump -sass``); with
    ``marker``, the count of instructions holding it under the key ``marker``."""
    tool = pathlib.Path(backend.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    funcs, ops = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops = funcs.setdefault(name, collections.Counter()) if kernel in name else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if ops is not None and m:
            ops[m.group(1)] += 1
            if marker is not None and marker in line:
                ops[marker] += 1
    if not funcs:
        raise AssertionError(f"no {kernel} SASS in {library}")
    return funcs


def _int_split(ops):
    """(ALU-only, multiply/add) integer instructions of one opcode Counter."""
    return (sum(ops[k] for k in SASS_ALU), sum(ops[k] for k in SASS_MULADD))


def _sass_ops(library):
    """(ALU-only, multiply/add) integer instructions in the SASS of the
    ``net_sweep_kernel`` of one built library: the static count of a
    straight-line body that runs once per item, with the item loop and the
    count epilogue around it."""
    return _int_split(sum(_sass_counts(library, "net_sweep_kernel").values(),
                          collections.Counter()))


def _sne_sass(library, kernel):
    """Static SASS counts of one SNE kernel: {"alu":, "muladd":, "total":,
    "hash_copies":, "alu_per_hash":, "muladd_per_hash":}.  A hash copy is two
    multiplies by SNE_HASH_CONST; the per-hash counts divide the whole
    kernel's (its item loop and indexing included) by the copies, so they read
    high by that overhead."""
    ops = sum(_sass_counts(library, kernel, SNE_HASH_CONST).values(), collections.Counter())
    alu, muladd = _int_split(ops)
    copies = ops[SNE_HASH_CONST] // 2
    return {"alu": alu, "muladd": muladd, "total": sum(ops.values()) - ops[SNE_HASH_CONST],
            "hash_copies": copies, "alu_per_hash": alu / copies if copies else None,
            "muladd_per_hash": muladd / copies if copies else None}


def _node_mux_sass(library):
    """{"gather m=3": {"alu":, "muladd":, "prmt":, "imad":}, "rows m=3 selected": ..}
    for each instance of the templated binary kernel: static counts of the
    whole kernel (the per-row threshold path and the item loop included)."""
    rows = {}
    for name, ops in _sass_counts(library, "node_mux_binary_kernel").items():
        m = re.search(r"node_mux_binary_kernelILi(\d)ELb([01])ELb([01])E", name)
        if m is None:
            continue
        kind = "gather" if m.group(2) == "0" else \
            ("rows selected" if m.group(3) == "1" else "rows every row")
        alu, muladd = _int_split(ops)
        rows[f"{kind} m={m.group(1)}"] = {"alu": alu, "muladd": muladd, "prmt": ops["PRMT"],
                                          "imad": ops["IMAD"], "total": sum(ops.values())}
    return rows


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
    spec = _spec(name)
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


PROFILER_DROPPED = []       # per timed kernel: launches a torch.profiler session did not record
L2_BYTES = 50 * 2**20       # H100 L2 cache (NVIDIA data sheet)
_L2_SCRATCH = []


def _flush_l2():
    """Write twice the L2's size, so that the next launch reads its inputs from HBM."""
    if not _L2_SCRATCH:
        _L2_SCRATCH.append(torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device="cuda"))
    _L2_SCRATCH[0].fill_(1)


def _device_ms(fn, reps=50, warmup=2, tries=5, kernel=None, cold=False):
    """Device time of the one kernel ``fn`` launches, per launch: the mean
    duration of its launches in a torch.profiler session of ``reps`` calls.
    Unlike :func:`_event_ms` it leaves out the host's cost of a launch,
    which sets back-to-back event times once a kernel is shorter than its
    launch.

    The profiler can drop some of a session's activities (on the H100 a few
    in most sessions once the unfused and wide phases have run, at times
    all), and a sum over the session would then read low.  So this takes the mean over the launches
    it recorded, checks that every recorded activity is that one kernel
    (one call launches exactly one, by the wrappers' launch counts; with
    ``kernel``, only activities whose name holds it are read, and the torch
    ops a wrapper runs around its launch are left out), and
    runs a session again, ``tries`` in all, when it recorded fewer than half
    of them.  ``PROFILER_DROPPED`` keeps the number dropped per timed
    kernel.  With ``cold`` (and ``kernel``), every launch follows a write of
    twice the L2's size, so that it reads its inputs from HBM as the bytes
    bound assumes."""
    from torch.profiler import ProfilerActivity, profile

    before = sum(_launches().values())
    fn()
    if sum(_launches().values()) - before != 1:
        raise AssertionError("a timed call must launch exactly one kernel of the port")
    if cold and kernel is None:
        raise ValueError("a cold timing names its kernel: the L2 flush is a kernel too")
    flush = _flush_l2 if cold else (lambda: None)
    for _ in range(warmup):
        flush()
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (kernel is None or kernel in e.name)]
        names = {name for name, _ in spans}
        if len(names) > 1 or len(spans) > reps:
            raise AssertionError(f"the timed call put more than its kernel on the card: "
                                 f"{len(spans)} activities over {reps} calls, {sorted(names)}")
        if 2 * len(spans) >= reps:
            PROFILER_DROPPED.append(reps - len(spans))
            return sum(us for _, us in spans) / len(spans) / 1e3
    raise AssertionError(f"torch.profiler recorded {len(spans)} of {reps} launches, "
                         f"in {tries} tries")


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


def _node_table(name, node):
    """(table, parent cards, card) of one node, one table for every row: the
    float32 CPT column (L,) of an all-binary node, else int32 CDF rows (L, k-1)."""
    spec = _spec(name)
    rows = spec.cpt_rows(node)
    card, pcards = spec.card(node), tuple(spec.card(p) for p in spec.node(node).parents)
    if card == 2 and all(c == 2 for c in pcards):
        return (torch.tensor([r[1] for r in rows], dtype=torch.float32, device="cuda"),
                pcards, card)
    return (torch.tensor([rng.cdf_thresholds_int(r) for r in rows], dtype=torch.int32,
                         device="cuda"), pcards, card)


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


def _nm_calls(name, kd, table, parents, cards, b):
    """(kernel, plain version) of one node_mux launch as zero-argument calls.

    The kernel gets the node's one table with row stride 0, as a compiled
    network passes it (the categorical table folded once, beforehand); the
    plain version gets the same table broadcast over the ``b`` rows.
    """
    rows_mode = name.startswith("node_mux_rows")
    n_rand_shape = (b, table.shape[0]) if rows_mode else (b,)
    rows = table.expand((b,) + tuple(table.shape))

    def entropy():
        return _entropy(NM_KEY, n_rand_shape, N_BITS, 0)

    if name.startswith("node_mux_cat"):
        folded = cat_table(table, cards)
        return (lambda: nm_kernel.node_mux_cat_cuda(*kd, folded, parents, cards=cards,
                                                    n_bits=N_BITS),
                lambda: cat_gather_body(rows, entropy(), parents, cards))
    if rows_mode:
        return (lambda: nm_kernel.node_mux_rows_cuda(*kd, rows, parents, n_bits=N_BITS),
                lambda: node_mux_ref(rows, entropy(), parents))
    return (lambda: nm_kernel.node_mux_gather_cuda(*kd, rows, parents, n_bits=N_BITS),
            lambda: node_mux_gather_ref(rows, entropy(), parents))


def _edge_rows(m):
    """(L,) shared CPT rows on the card that together hold every EDGE_P value:
    one row once L holds them all, else as many as they need."""
    n_leaves = 1 << m
    fill = torch.rand(n_leaves, generator=torch.Generator().manual_seed(m))
    rows = []
    for i in range(0, len(EDGE_P), n_leaves):
        row = fill.clone()
        chunk = torch.tensor(EDGE_P[i:i + n_leaves])
        row[: chunk.numel()] = chunk
        rows.append(row.cuda())
    return rows


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


def _router(policy, max_batch, device, **kw):
    return BayesRouter(policy, ROUTER_KEY, n_bits=N_BITS, max_batch=max_batch,
                       max_cached_tenants=len(NAMES), device=device, **kw)


def _router_workload(n_frames, seed):
    """Per-tenant evidence, drawn by ancestral sampling from seeded keys."""
    return {n: analytic.sample_evidence(by_name(n), prng.PRNGKey(seed + i), n_frames,
                                        device="cpu").numpy() for i, n in enumerate(NAMES)}


def _router_round(router, workload, deadline_ms=None):
    """Submit the workload round-robin in chunks, drain; every rid exactly once."""
    rids = []
    n = len(next(iter(workload.values())))
    t0 = time.perf_counter()
    for lo in range(0, n, ROUTER_CHUNK):
        for name, ev in workload.items():
            rids += router.submit(name, ev[lo:lo + ROUTER_CHUNK], deadline_ms=deadline_ms)
    out = router.drain()
    wall = time.perf_counter() - t0
    if sorted(out) != sorted(rids) or len(set(rids)) != len(rids):
        lost = len(set(rids) - set(out))
        raise AssertionError(f"the router's round lost {lost} frames or emitted others")
    for rid in rids:
        if router.results[rid].status not in TERMINAL_STATUSES:
            raise AssertionError(f"rid {rid}: status {router.results[rid].status}")
    return rids, out, wall


def _census(router, rids):
    out = {s: 0 for s in TERMINAL_STATUSES}
    for rid in rids:
        out[router.results[rid].status] += 1
    return out


def _router_same(card, cpu, rids, what):
    for rid in rids:
        a, b = card.results[rid], cpu.results[rid]
        if (a.tenant, a.status, a.accepted, a.degrade_level) != \
                (b.tenant, b.status, b.accepted, b.degrade_level) or \
                (a.post is None) != (b.post is None) or \
                (a.post is not None and not np.array_equal(a.post, b.post)):
            raise AssertionError(f"router {what}: rid {rid} differs between the card "
                                 f"({a.status}) and the CPU ({b.status})")


def _busy_us(prof):
    """(the union of a profile's device intervals in us, their number)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


# --- the reliable decision path (phases reliability and drift): the reference
# flows benchmarks/bench_reliability.py and benchmarks/bench_drift.py at their
# own sizes, copied here because benchmarks imports jax.  Each flow runs on one
# device and returns a dict that must be equal card against CPU, bit for bit,
# apart from its "meta" entry: the oracle's float posteriors (summed in another
# order on each device), host times, and the plans the flow compiled.
REL_FRAMES = 512                       # evidence frames per scenario, from PRNGKey(1)
REL_SCALES = (0.0, 0.5, 1.0, 2.0)      # x NoiseModel.nominal(); scale 0 is noise=None
REL_SCALE_BITS = 1024
REL_NBITS = (256, 1024, 4096)          # under nominal noise
REL_RETRY_NAMES = ("obstacle-detection", "lane-change", "intersection-cat")
REL_RETRY_BITS = 256
REL_RETRY = dict(min_confidence=0.9, max_retries=2, escalation=4, max_n_bits=1 << 14)
MAX_NOMINAL_FLIP = 0.15                # benchmarks/check_bench.py's limits
MAX_RETRY_OVERHEAD = 8.0
DRIFT_NOISE = dict(seed=4, wear_tau=4.0)
DRIFT_BITS, DRIFT_BATCH, DRIFT_LAUNCHES = 1024, 128, 7
DRIFT_CYCLE_STEP = 2                   # cycles of wear per launch
DRIFT_RECAL_EVERY = 2                  # the closed arm refits its program every other launch
DRIFT_EPOCHS = 2                       # each launch's stream spans two noise snapshots
DRIFT_FINAL_REPEATS = 8                # the final cycle's flip averages this many launches
DRIFT_SALT = 17
DRIFT_FLIP_TOL, DRIFT_MIN_WINS = 0.008, 5
SWAP_NAME, SWAP_FRAMES, SWAP_BATCH, SWAP_SALT = "pedestrian-night", 16, 4, 99
SWAP_NOISE = dict(seed=4, cycle=4, wear_tau=4.0)
SWAP_CYCLE = 8                         # the recalibrated twin's cycle
SWAP_DELAY_CYCLES = 1 << 30            # device clocks queued ahead of the swap's launches
MONITOR_CASES = (("pedestrian-night", True), ("intersection-cat", False),
                 ("sensor-degradation", True))       # tests/test_torch_drift.py's cases
MONITOR_NOISE = dict(seed=9, cycle=3, wear_tau=1.0)
MONITOR_POLICY = dict(warmup=4, drift_h=0.5, recal_h=2.0)
MONITOR_BITS, MONITOR_BATCH, MONITOR_FRAMES, MONITOR_SALT = 256, 4, 40, 41
MONITOR_KEY = prng.PRNGKey(5)


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _drained(drv, ev, mode="sync"):
    """Submit ``ev``, drain in ``mode``: (rids, {rid: (post, accepted)}), every rid once."""
    rids = drv.submit(ev)
    out = drv.drain_async() if mode == "async" else drv.drain()
    if sorted(out) != rids:
        raise AssertionError(f"a drain lost {len(set(rids) - set(out))} frames")
    return rids, out


def _stats(stats):
    """A driver's ReliabilityStats without ``slow_launches``, which the host clock sets."""
    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "slow_launches"}


def flip_curves(name, device, frames=REL_FRAMES, scales=REL_SCALES,
                scale_bits=REL_SCALE_BITS, n_bits=REL_NBITS):
    """One scenario of bench_reliability's sweep: the MAP flip rate against the
    clean DAC-quantised oracle as the noise scales (at ``scale_bits``) and as
    the stream grows (nominal noise); one ``decide`` of all frames each."""
    spec = by_name(name)
    ev = analytic.sample_evidence(spec, prng.PRNGKey(1), frames, device=device)
    exact, _ = analytic.make_posterior_fn(spec, dac_quantize=True, device=device)(ev)
    ref = _host(posterior_argmax(exact))
    nominal, key, plans = NoiseModel.nominal(), prng.PRNGKey(0), []

    def decide(nb, noise):
        net = compile_network(spec, n_bits=nb, noise=noise, device=device)
        plans.append(net.plan)
        post, dec, acc = (_host(t) for t in net.decide(key, ev))
        return {"post": post, "dec": dec, "accepted": acc, "flip": flip_rate(dec, ref)}

    by_scale = {s: decide(scale_bits, None if s == 0 else nominal.scaled(s)) for s in scales}
    by_bits = {nb: by_scale[1.0] if nb == scale_bits and 1.0 in by_scale else decide(nb, nominal)
               for nb in n_bits}
    return {"ref": ref, "scale": by_scale, "n_bits": by_bits,
            "meta": {"oracle": _host(exact), "plans": plans}}


def retry_race(name, device, mode="sync", frames=REL_FRAMES):
    """bench_reliability's retry race on one scenario: a confidence-gated
    retrying driver against a flat one given at least its mean bits per frame,
    both scored against the perturbed oracle's decisions."""
    spec = by_name(name)
    nominal = NoiseModel.nominal()
    ev = _host(analytic.sample_evidence(spec, prng.PRNGKey(1), frames, device=device))
    exact, _ = analytic.make_posterior_fn(spec, noise=nominal, device=device)(ev)
    ref = _host(posterior_argmax(exact))
    plans, seconds = [], {}

    def serve(arm, n_bits, retry):
        net = compile_network(spec, n_bits=n_bits, noise=nominal, device=device)
        plans.append(net.plan)
        drv = FrameDriver(net, max_batch=frames, salt=0, retry=retry)
        t0 = time.perf_counter()
        rids, out = _drained(drv, ev, mode)
        seconds[arm] = time.perf_counter() - t0
        post = np.stack([out[r][0] for r in rids])
        dec = _host(posterior_argmax(post))
        return drv, {"post": post, "accepted": np.asarray([out[r][1] for r in rids]),
                     "dec": dec, "flip": flip_rate(dec, ref)}

    drv, retried = serve("retry", REL_RETRY_BITS, RetryPolicy(**REL_RETRY))
    flat_bits = int(-(-drv.stats.mean_bits // 32) * 32)     # the word grid, rounded up
    _, flat = serve("flat", flat_bits, None)
    return {"ref": ref, "retry": retried, "flat": flat, "flat_bits": flat_bits,
            "stats": _stats(drv.stats), "overhead": drv.stats.mean_bits / REL_RETRY_BITS,
            "reports": {rid: dataclasses.asdict(r) for rid, r in sorted(drv.reports.items())},
            "meta": {"oracle": _host(exact), "plans": plans, "seconds": seconds}}


def aging_race(name, device, n_bits=DRIFT_BITS, batch=DRIFT_BATCH, launches=DRIFT_LAUNCHES,
               final_repeats=DRIFT_FINAL_REPEATS):
    """bench_drift's race on one scenario: the array ages DRIFT_CYCLE_STEP
    cycles per launch under two drivers; the open arm swaps to the aged plan,
    the closed arm to the aged plan with its program refit by
    ``compensated_program`` every DRIFT_RECAL_EVERY launches.  Flip rates
    against the clean DAC-quantised oracle, the final cycle's averaged over
    ``final_repeats`` launches."""
    spec = by_name(name)
    nm = NoiseModel(**DRIFT_NOISE)
    ev = _host(analytic.sample_evidence(spec, prng.PRNGKey(3), batch, device=device))
    exact, _ = analytic.make_posterior_fn(spec, dac_quantize=True, device=device)(ev)
    ref = _host(posterior_argmax(exact))
    plans, swap_s, closed_s = [], [], []

    def plan(cycle, program_cycle=None):
        prog = None if program_cycle is None else tbn.compensated_program(
            spec, nm.with_cycle(program_cycle), drift_epochs=DRIFT_EPOCHS)
        net = compile_network(spec, n_bits, noise=nm.with_cycle(cycle), drift_epochs=DRIFT_EPOCHS,
                              program=prog, devices=1, device=device)
        plans.append(net.plan)
        return net

    drv_open = FrameDriver(plan(0), max_batch=batch, salt=DRIFT_SALT)
    drv_closed = FrameDriver(plan(0, 0), max_batch=batch, salt=DRIFT_SALT)
    recals, prog_cycle, rows, posts = 1, 0, [], []
    for i in range(launches):
        cycle = i * DRIFT_CYCLE_STEP
        if i > 0:
            aged = plan(cycle)
            if i % DRIFT_RECAL_EVERY == 0:
                prog_cycle = cycle
                recals += 1
            refit = plan(cycle, prog_cycle)
            t0 = time.perf_counter()
            drv_open.swap_net(aged)
            drv_closed.swap_net(refit)
            swap_s.append(time.perf_counter() - t0)
        reps = final_repeats if i == launches - 1 else 1
        flip_open = flip_closed = 0.0
        for _ in range(reps):
            rids, out = _drained(drv_open, ev)
            po = np.stack([out[r][0] for r in rids])
            t0 = time.perf_counter()
            rids, out = _drained(drv_closed, ev)
            closed_s.append(time.perf_counter() - t0)
            pc = np.stack([out[r][0] for r in rids])
            flip_open += flip_rate(_host(posterior_argmax(po)), ref)
            flip_closed += flip_rate(_host(posterior_argmax(pc)), ref)
            posts.append((po, pc))
        flip_open /= reps
        flip_closed /= reps
        rows.append((i, cycle, flip_open, flip_closed, recals))
    return {"ref": ref, "rows": rows, "posts": posts, "flip_open": flip_open,
            "flip_closed": flip_closed, "recals": recals,
            "meta": {"oracle": _host(exact), "plans": plans, "swap_s": swap_s,
                     "closed_s": closed_s}}


def hot_swap(device, delay_cycles=0):
    """bench_drift's hot swap: a driver swaps to a recalibrated twin with two
    launches (8 frames) dispatched and not harvested, beside a never-swapped
    twin driver.  On the card ``delay_cycles`` of device work queued ahead of
    the four launches keep them pending until the swap has returned; each
    launch's recorded event is queried just before and just after it.  The
    twin network is built before the launches, so the timed swap is the swap
    alone (``recal_s`` is its own time)."""
    spec = by_name(SWAP_NAME)
    net = compile_network(spec, DRIFT_BITS, noise=NoiseModel(**SWAP_NOISE),
                          drift_epochs=DRIFT_EPOCHS, devices=1, device=device)
    ev = _host(analytic.sample_evidence(spec, prng.PRNGKey(5), SWAP_FRAMES, device=device))
    t0 = time.perf_counter()
    recal = tbn.recalibrated_network(net, cycle=SWAP_CYCLE)
    recal_s = time.perf_counter() - t0
    twin = FrameDriver(net, max_batch=SWAP_BATCH, salt=SWAP_SALT)
    swapped = FrameDriver(net, max_batch=SWAP_BATCH, salt=SWAP_SALT)
    t_rids, s_rids = twin.submit(ev), swapped.submit(ev)
    if delay_cycles:
        # four launches of the drivers' shape, so that their pinned uploads and
        # outputs find cached blocks: no allocation may wait on the delay below
        for _ in range(4):
            net.run(prng.PRNGKey(0), ev[:SWAP_BATCH])
        torch.cuda.synchronize()
        torch.cuda._sleep(delay_cycles)
    for drv in (twin, swapped):
        drv.step(block=False)
        drv.step(block=False)                    # two launches (8 frames) in flight
    # the driver's own launch records: a pending launch's event has not completed
    pending = [lf.done is not None and not lf.done.query() for lf in swapped._inflight]
    t0 = time.perf_counter()
    swapped.swap_net(recal)
    swap_s = time.perf_counter() - t0
    pending_after = [lf.done is not None and not lf.done.query() for lf in swapped._inflight]
    out_twin, out_swapped = twin.drain(), swapped.drain()
    lost = len(set(s_rids) - set(out_swapped))
    pre = 2 * SWAP_BATCH                         # frames dispatched before the swap
    preserved = lost == 0 and swapped.net is recal and all(
        np.array_equal(out_twin[t][0], out_swapped[s][0]) and out_twin[t][1] == out_swapped[s][1]
        for t, s in zip(t_rids[:pre], s_rids[:pre]))
    return {"twin": out_twin, "swapped": out_swapped, "lost": lost, "preserved": preserved,
            "meta": {"plans": [net.plan, recal.plan], "pending_at_swap": pending,
                     "pending_after_swap": pending_after, "swap_s": swap_s, "recal_s": recal_s}}


class _RecordingMonitor(tbn.DriftMonitor):
    """A drift monitor that keeps, per launch, what it was fed and its snapshot."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trajectory = []

    def observe_launch(self, confidence, accept_rate, flip=None):
        state = super().observe_launch(confidence, accept_rate, flip)
        self.trajectory.append((confidence, accept_rate, state, self.as_dict()))
        return state


def monitor_run(name, noisy, mode, device):
    """tests/test_torch_drift.py's drift feed: a FrameDriver with a DriftMonitor
    (low limits, so the states move) drains seeded frames; the monitor's
    per-launch (confidence, accept_rate, state, as_dict())."""
    spec = by_name(name)
    net = compile_network(spec, MONITOR_BITS, noise=NoiseModel(**MONITOR_NOISE) if noisy else None,
                          device=device)
    mon = _RecordingMonitor(tbn.DriftPolicy(**MONITOR_POLICY))
    drv = FrameDriver(net, max_batch=MONITOR_BATCH, base_key=MONITOR_KEY, salt=MONITOR_SALT,
                      drift=mon)
    _, out = _drained(drv, _evidence(spec, MONITOR_FRAMES, seed=7), mode)
    return {"out": out, "trajectory": mon.trajectory, "launches": drv.launches,
            "meta": {"plans": [net.plan]}}


def held_equal(got, want, path="flow"):
    """Raise where ``got`` differs from ``want``: dicts, sequences, arrays and
    scalars compared exactly, value for value; "meta" entries are skipped."""
    if isinstance(want, dict):
        keys = set(want) - {"meta"}
        if set(got) - {"meta"} != keys:
            raise AssertionError(f"{path}: keys {sorted(map(str, got))} != {sorted(map(str, want))}")
        for k in keys:
            held_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} entries != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            held_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        g, w = np.asarray(got), np.asarray(want)
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{path}: arrays differ")
    elif got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


# --- the paper layer (core/*, examples/*) at the reference benchmarks' own sizes
# (benchmarks/bench_fig1..4, bench_table_s1; examples/*.py).  Each flow runs on
# one device and returns named results; PAPER_RULES says how the card's result
# is held against the CPU's: "exact" (streams, counts, ratios of counts, and
# the float work both devices round alike), or (atol, rtol) with its reason.
PAPER_KEY = prng.PRNGKey(0)
OU_ATOL = 1e-5        # V: normal() differs by a few ulp (log1p, sqrt), damped by the AR(1)
NORMAL_RTOL = 1e-5    # exp() of such draws, and the mean's summation order
CURVE_ATOL = 1e-6     # sigmoid / log of the transfer curves
ORACLE_ATOL = 5e-7    # the enumeration oracle's float32 sums, summed in another order
RATE_ATOL = 0.01      # detection rates: a pixel within fusion_map's tolerance of the
                      # 0.6 threshold may flip; one pixel moves a scene's rate by < 0.008
VIA_MARGIN = 1e-5     # V: encode_via_device's bits are compared where |V_in - V_th| > this
VIA_COUNT = 2         # ... and each stream's popcount within this many bits
FUSION_TILE, FUSION_M, FUSION_K, FUSION_BITS = 4096, 2, 16, 128   # paper-bayes-fusion widths
VIA_STREAMS, VIA_BITS = 1024, 1024
INFER_BATCH, INFER_BITS = 4096, 128   # bench_fig3's batched operator


def _fold(i):
    return prng.fold_in(PAPER_KEY, i)


def _paper_fig1(dev):
    """bench_fig1_device: the OU path (20,000 cycles), 1000 devices, the OU
    fit, an endurance trace of 100,000 cycles."""
    t0 = time.perf_counter()
    path = memristor.sample_ou_path(PAPER_KEY, 20000, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    ou_s = time.perf_counter() - t0
    mus = memristor.sample_devices(prng.PRNGKey(1), 1000, device=dev)
    hrs, lrs = memristor.endurance_trace(prng.PRNGKey(2), 100000, device=dev)
    fit = torch.tensor(memristor.fit_ou(path), dtype=torch.float64)
    return {"path": path, "mus": mus, "hrs": hrs, "lrs": lrs, "fit": fit, "ou_s": ou_s,
            "summary": {"vth_mean": float(path.mean()), "vth_std": float(path.std()),
                        "d2d_cv": float(mus.std() / mus.mean()),
                        "ou_fit": fit.tolist(),
                        "min_hrs_over_max_lrs": float(hrs.min() / lrs.max())}}


def _paper_fig2(dev):
    """bench_fig2_logic: six transfer-curve points at 2**14 bits, AND in three
    modes and MUX over 50 keys at 100 bits, AND's precision at 100, 1000 and
    10,000 bits over 20 keys."""
    n = 1 << 14
    curves, streams = [], []
    for fn, vs, scale in ((sne.p_from_vin, (1.8, 2.24, 2.8), 100),
                          (sne.p_from_vref, (0.4, 0.57, 0.75), 1000)):
        for v in vs:
            p_t = fn(v, device=dev)
            curves.append(p_t)
            streams.append(sne.encode_uncorrelated(_fold(int(v * scale)), p_t, n, device=dev))
    out = {"curves": torch.stack(curves), "curve_streams": torch.stack(streams)}
    for mode in logic.Corr:
        runs = [logic.prob_and(_fold(i), 0.8, 0.6, 100, mode, device=dev) for i in range(50)]
        out[f"and_{mode.value}"] = torch.stack([r[0] for r in runs])
        out[f"and_{mode.value}_est"] = torch.stack([r[1] for r in runs])
    runs = [logic.prob_mux(_fold(i), 0.5, 0.8, 0.6, 100, device=dev) for i in range(50)]
    out["mux"] = torch.stack([r[0] for r in runs])
    for nbits in (100, 1000, 10000):
        out[f"precision_{nbits}"] = torch.stack([
            logic.prob_and(_fold(100 + i), 0.8, 0.6, nbits, logic.Corr.UNCORRELATED,
                           device=dev)[1] for i in range(20)])
    out["summary"] = {
        **{f"and_{m.value}_mean": float(out[f"and_{m.value}_est"].mean()) for m in logic.Corr},
        **{f"precision_{nb}_mean_abs_err": float((out[f"precision_{nb}"] - 0.48).abs().mean())
           for nb in (100, 1000, 10000)}}
    return out


def _paper_table_s1(dev):
    """bench_table_s1: AND/OR/XOR x 3 correlation modes and the MUX at 2**14 bits."""
    n, pa, pb = 1 << 14, 0.7, 0.4
    out, summary = {}, {}
    ops = (("AND", logic.prob_and, logic.expected_and), ("OR", logic.prob_or, logic.expected_or),
           ("XOR", logic.prob_xor, logic.expected_xor))
    for j, (name, op, expected) in enumerate(ops):
        for m, mode in enumerate(logic.Corr):
            c, est, _ = op(_fold(3 * j + m), pa, pb, n, mode, device=dev)
            exp = expected(pa, pb, mode, device=dev)
            out[f"{name}_{mode.value}"], out[f"{name}_{mode.value}_expected"] = c, exp
            summary[f"{name}[{mode.value}]"] = (float(exp), float(est))
    c, est, _ = logic.prob_mux(PAPER_KEY, 0.3, pa, pb, n, device=dev)
    out["MUX"] = c
    summary["MUX"] = (float(logic.expected_mux(0.3, pa, pb, device=dev)), float(est))
    out["summary"] = summary
    return out


def _paper_fig3(dev):
    """bench_fig3_inference: the route-planning posterior over 100 keys and a
    prior/likelihood grid over 20 keys each at 100 bits; the correlation
    matrices at 2**14 bits; the marginal variant; the two Fig S8 motifs at
    2**13 bits; the batched operator (4096 inferences at 128 bits)."""
    out = {}
    runs = [inference.bayes_inference(_fold(i), 0.57, 0.72, 0.6, n_bits=100, device=dev)
            for i in range(100)]
    out["route_ratio"] = torch.stack([r.posterior_ratio for r in runs])
    out["route_scan"] = torch.stack([r.posterior_scan for r in runs])
    grid = []
    for a, pa in enumerate((0.2, 0.4, 0.6, 0.8)):
        for b, pba in enumerate((0.3, 0.6, 0.9)):
            grid += [inference.bayes_inference(_fold(1000 + 100 * (3 * a + b) + i), pa, pba, 0.5,
                                               n_bits=100, device=dev).posterior_ratio
                     for i in range(20)]
    out["grid"] = torch.stack(grid)
    tr = inference.bayes_inference(PAPER_KEY, 0.57, 0.72, 0.6, n_bits=1 << 14, device=dev)
    out["streams"] = torch.stack(list(tr.streams.values()))
    out["pearson"] = correlation.correlation_matrix(tr.streams, tr.n_bits, "pearson")
    out["scc"] = correlation.correlation_matrix(tr.streams, tr.n_bits, "scc")
    mg = inference.bayes_inference_marginal(PAPER_KEY, 0.57, 0.78, 0.72, n_bits=1 << 14,
                                            device=dev)
    out["marginal"] = torch.stack([mg.posterior_scan, mg.posterior_ratio])
    out["marginal_denom"] = mg.streams["denom"]
    cpt = [[0.1, 0.4], [0.6, 0.9]]
    s8b = graph.two_parent_one_child(PAPER_KEY, 0.6, 0.3, cpt, n_bits=1 << 13, device=dev)
    s8c = graph.one_parent_two_child(PAPER_KEY, 0.5, (0.9, 0.2), (0.8, 0.3), n_bits=1 << 13,
                                     device=dev)
    out["s8"] = torch.stack(list(s8b[:2]) + list(s8c[:2]))
    out["s8_analytic"] = torch.stack([s8b[2], s8c[2]])
    pa_v = torch.full((INFER_BATCH,), 0.57, device=dev)
    batched = inference.bayes_inference(PAPER_KEY, pa_v, 0.72, 0.6, n_bits=INFER_BITS, device=dev)
    out["batched"] = batched.posterior_ratio
    names = list(tr.streams)
    i_a, i_n, i_d = names.index("A"), names.index("numer"), names.index("denom")
    out["summary"] = {
        "route_theory": float(tr.posterior_analytic), "route_mean_100bit": float(out["route_ratio"].mean()),
        "route_std_100bit": float(out["route_ratio"].std()),
        "rho_A_BA": float(out["pearson"][i_a, names.index("B|A")]),
        "rho_numer_denom": float(out["pearson"][i_n, i_d]), "scc_numer_denom": float(out["scc"][i_n, i_d]),
        "marginal": [float(v) for v in out["marginal"]], "s8": [float(v) for v in out["s8"]],
        "s8_analytic": [float(v) for v in out["s8_analytic"]]}
    return out


def _paper_fig4(dev):
    """bench_fig4_fusion: 30 scenes of 64x64 through make_scene and fusion_map,
    detection_fusion of 64 boxes at 4096 bits; then bayes_fusion at
    paper-bayes-fusion's widths (M=2, K=16, 128 bits) on a 4096-pixel tile
    under both entropy generators."""
    cfg = detection.SceneConfig(height=64, width=64)
    maps, rates = [], []
    for i in range(30):
        gt, p_rgb, p_th, _ = detection.make_scene(_fold(i), cfg, device=dev)
        pm = torch.stack([torch.stack([q, 1 - q], -1).reshape(-1, 2) for q in (p_rgb, p_th)])
        fused = fusion_map(pm, device=dev)[:, 0].reshape(gt.shape)
        maps.append(torch.stack([gt, p_rgb, p_th]))
        rates.append(torch.stack([torch.stack(detection.detection_metrics(gt, q))
                                  for q in (p_rgb, p_th, fused)]))
    out = {"scenes": torch.stack(maps), "rates": torch.stack(rates)}
    _, p_rgb, p_th, _ = detection.make_scene(_fold(999), cfg, device=dev)
    sel = torch.stack([p_rgb.reshape(-1)[:64], p_th.reshape(-1)[:64]], dim=-1)
    out["detection"] = fusion.detection_fusion(prng.PRNGKey(7), sel, n_bits=1 << 12, device=dev)
    out["detection_analytic"] = fusion.fuse_analytic(torch.stack([sel, 1 - sel], -1))[:, 0]
    p = np.random.default_rng(4).dirichlet(np.ones(FUSION_K), size=(FUSION_TILE, FUSION_M))
    for impl in ("fast", "threefry"):
        tr = fusion.bayes_fusion(PAPER_KEY, p.astype(np.float32), n_bits=FUSION_BITS, impl=impl,
                                 device=dev)
        out[f"fusion_{impl}_streams"] = torch.cat([tr.streams["numer"],
                                                   tr.streams["denom"][:, None]], 1)
        out[f"fusion_{impl}"] = torch.stack([tr.fused_scan, tr.fused_ratio])
        out[f"fusion_{impl}_analytic"] = tr.fused_analytic
    mean_rates = out["rates"].mean(0)[:, 0]
    agree = (out["fusion_fast"][1].argmax(-1) == out["fusion_fast_analytic"].argmax(-1))
    out["summary"] = {
        "detection_rate_rgb_thermal_fused": [float(v) for v in mean_rates],
        "confidence_rgb_thermal_fused": [float(v) for v in out["rates"].mean(0)[:, 2]],
        "detection_mean_abs_err": float((out["detection"] - out["detection_analytic"]).abs().mean()),
        "tile_argmax_agreement": float(agree.to(torch.float32).mean())}
    return out


def _paper_via_device(dev):
    """encode_via_device: 1024 streams x 1024 bits, each on its own OU path."""
    p = np.random.default_rng(6).uniform(0.02, 0.98, VIA_STREAMS).astype(np.float32)
    words = sne.encode_via_device(PAPER_KEY, p, VIA_BITS, device=dev)
    v_in, vth = sne.device_levels(PAPER_KEY, p, VIA_BITS, device=dev)
    est = bitops.decode(words, VIA_BITS)
    return {"words": words, "v_in": v_in, "vth": vth,
            "summary": {"mean_abs_err_vs_p": float((est.cpu() - torch.from_numpy(p)).abs().mean())}}


def _paper_quickstart(dev):
    r = quickstart.run(dev)
    tr, ftr = r["inference"], r["fusion"]
    return {"streams": torch.stack([r["stream"], r["and_unc"], r["and_pos"], r["quotient"]]),
            "inference_streams": torch.stack(list(tr.streams.values())),
            "inference": torch.stack([tr.posterior_scan, tr.posterior_ratio]),
            "inference_analytic": tr.posterior_analytic,
            "fusion_streams": torch.cat([ftr.streams["numer"], ftr.streams["denom"][None]]),
            "fusion": torch.stack([ftr.fused_scan, ftr.fused_ratio]),
            "fusion_analytic": ftr.fused_analytic,
            "summary": {"inference": float(tr.posterior_ratio), "fusion": float(ftr.fused_ratio[0])}}


def _paper_route_planning(dev):
    r = route_planning.run(dev)
    return {"frames": torch.tensor(np.stack([np.append(post, acc) for _, (post, acc) in r["frames"]])),
            "theory": r["theory"], "rho": r["rho"],
            "audit_streams": torch.stack([r["streams"][n][0] for n in r["names"]]),
            "summary": {"posteriors": [float(post[0]) for _, (post, _) in r["frames"]],
                        "rho": r["rho"].cpu().tolist()}}


def _paper_scene_graph(dev):
    r = scene_graph.run(dev)
    streamed = r["streamed"]
    post, dec, acc = r["decide"]
    return {"motif": torch.stack([r["motif_post"][0, 0], r["motif_acc"][0].to(torch.float32)]),
            "motif_expect": r["motif_expect"], "post": r["post"], "acc": r["acc"],
            "shared_post": r["shared_post"], "exact": r["exact"],
            "streamed": torch.tensor(np.stack([streamed[i][0] for i in (0, 1)])),
            "class_post": r["class_post"], "class_acc": r["class_acc"],
            "decide": torch.cat([post.reshape(-1), dec.reshape(-1).to(torch.float32),
                                 acc.reshape(-1).to(torch.float32)]),
            "summary": {"frames_per_s_fused": float(r["ev"].shape[0] / r["seconds"]),
                        "shared_over_fused": float(r["shared_seconds"] / r["seconds"]),
                        "oracle_mean_abs_err": float(r["err"].mean()),
                        "class_frames_per_s": float(r["ev"].shape[0] / r["class_seconds"])}}


def _paper_obstacle_fusion(dev):
    r = obstacle_fusion.run(dev)
    return {"fused": r["fused"], "dec": r["dec"], "cnt": r["cnt"],
            "rates": torch.tensor([r["rates"][n] for n in ("RGB", "thermal", "fused")]),
            "summary": {"rates": r["rates"], "mean_abs_err": r["mean_abs_err"],
                        "agreement": r["agreement"]}}


_EXACT = "exact"
FM_TOL = (FM_ATOL, FM_RTOL)
# flow -> (function, {result: rule}); results a rule does not name are reported only
PAPER_FLOWS = {
    "fig1": (_paper_fig1, {"path": (OU_ATOL, 0.0), "mus": (1e-6, 0.0), "hrs": (0.0, NORMAL_RTOL),
                           "lrs": (0.0, NORMAL_RTOL), "fit": (OU_ATOL, 0.0)}),
    "fig2": (_paper_fig2, {"curves": (CURVE_ATOL, 0.0), "curve_streams": _EXACT,
                           **{f"and_{m.value}{x}": _EXACT for m in logic.Corr for x in ("", "_est")},
                           "mux": _EXACT, **{f"precision_{nb}": _EXACT for nb in (100, 1000, 10000)}}),
    "table_s1": (_paper_table_s1, {**{f"{op}_{m.value}{x}": (_EXACT if not x else (1e-7, 0.0))
                                      for op in ("AND", "OR", "XOR") for m in logic.Corr
                                      for x in ("", "_expected")}, "MUX": _EXACT}),
    "fig3": (_paper_fig3, {k: _EXACT for k in ("route_ratio", "route_scan", "grid", "streams",
                                               "pearson", "scc", "marginal", "marginal_denom",
                                               "s8", "batched")} | {"s8_analytic": (1e-7, 0.0)}),
    "fig4": (_paper_fig4, {"scenes": _EXACT, "rates": (RATE_ATOL, 0.0), "detection": _EXACT,
                           "detection_analytic": FM_TOL,
                           **{f"fusion_{i}{x}": FM_TOL if x == "_analytic" else _EXACT
                              for i in ("fast", "threefry") for x in ("_streams", "", "_analytic")}}),
    "encode_via_device": (_paper_via_device, {"v_in": (OU_ATOL, 0.0), "vth": (OU_ATOL, 0.0)}),
    "quickstart": (_paper_quickstart, {"streams": _EXACT, "inference_streams": _EXACT,
                                       "inference": _EXACT, "inference_analytic": (1e-7, 0.0),
                                       "fusion_streams": _EXACT, "fusion": _EXACT,
                                       "fusion_analytic": FM_TOL}),
    "route_planning": (_paper_route_planning, {"frames": _EXACT, "theory": (ORACLE_ATOL, 0.0),
                                               "rho": _EXACT, "audit_streams": _EXACT}),
    "scene_graph": (_paper_scene_graph, {"motif": _EXACT, "motif_expect": (1e-7, 0.0),
                                         "post": _EXACT, "acc": _EXACT, "shared_post": _EXACT,
                                         "exact": (ORACLE_ATOL, 0.0), "streamed": _EXACT,
                                         "class_post": _EXACT, "class_acc": _EXACT,
                                         "decide": _EXACT}),
    "obstacle_fusion": (_paper_obstacle_fusion, {"fused": FM_TOL, "dec": _EXACT, "cnt": _EXACT,
                                                 "rates": (RATE_ATOL, 0.0)}),
}


def _hold(flow, card, cpu, rules):
    """Hold the card's named results against the CPU's by ``rules``; returns
    {result: max abs difference}."""
    errs = {}
    for name, rule in rules.items():
        a = torch.as_tensor(card[name]).cpu()
        b = torch.as_tensor(cpu[name]).cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{flow}.{name}: card {tuple(a.shape)} {a.dtype}, "
                                 f"CPU {tuple(b.shape)} {b.dtype}")
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        errs[name] = float(diff.max()) if diff.numel() else 0.0
        if rule == _EXACT:
            bad = a != b
        else:
            atol, rtol = rule
            bad = ~(diff <= atol + rtol * b.to(torch.float64).abs())
        if bool(bad.any()):
            i = int(torch.nonzero(bad.reshape(-1))[0])
            at = tuple(int(j) for j in np.unravel_index(i, tuple(a.shape)))
            raise AssertionError(
                f"{flow}.{name}: the card differs from the CPU beyond {rule} at "
                f"{int(bad.sum())} of {bad.numel()} elements (max abs diff {errs[name]}); "
                f"first at index {at}: card {a.reshape(-1)[i].item()!r}, "
                f"CPU {b.reshape(-1)[i].item()!r}")
    return errs


def _hold_via_device(card, cpu):
    """The margin rule: bits equal wherever both devices put |V_in - V_th|
    above VIA_MARGIN, and each stream's popcount within VIA_COUNT."""
    bits = [bitops.unpack_bits(r["words"].cpu(), VIA_BITS).to(torch.bool) for r in (card, cpu)]
    clear = torch.ones_like(bits[0])
    for r in (card, cpu):
        clear &= ((r["v_in"][:, None] - r["vth"]).abs() > VIA_MARGIN).cpu()
    flips = int((bits[0] != bits[1])[clear].sum())
    count_diff = int((bitops.popcount(card["words"].cpu()) - bitops.popcount(cpu["words"])).abs().max())
    inside = int((~clear).sum())
    if flips or count_diff > VIA_COUNT:
        raise AssertionError(f"encode_via_device: {flips} bits differ outside the margin, "
                             f"popcounts differ by up to {count_diff}")
    return {"bits_inside_margin": inside, "bits_differing_outside": flips,
            "popcount_max_diff": count_diff}



# the LM serving path (lm_serve): the archs of the attention-only decoder stack
LM_ARCH = "phi3-mini-3.8b"            # served at its published config, every layer
LM_ARCHS = ("qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b")
LM_ENGINE = EngineConfig(max_batch=4, t_cache=128, bayes_gate=True, stochastic_gate=True,
                         gate_n_bits=256)
LM_REQUESTS, LM_NEW_TOKENS = 6, 16    # 6 requests on 4 slots: two wait and join mid-flight
LM_CUT_LAYERS = 2                     # card against CPU at full width: depth cut to 2 layers
LM_PATCHES = 4                        # internvl2's stub patch embeddings
# tests/models/test_smoke_archs.py's own tolerances: decode after prefill against
# the teacher-forced forward (prefill 2e-2, decode 1e-1), used here for card against CPU
LM_PREFILL_TOL, LM_DECODE_TOL = (2e-2, 2e-2), (1e-1, 1e-1)
# card against CPU at full width: cuBLAS and the CPU's GEMM sum the 3072-8192
# products of every bf16 matmul in other orders, so the hidden state differs by
# bf16 ulps, which sum to a few 1e-2 in a logit of scale 1 (phi3 at 2 layers on
# an H100: up to 0.035, beyond the prefill bound's 2e-2 + 2e-2 |x|); held
# within the decode bound's atol
LM_WIDE_TOL = (1e-1, 2e-2)
# the recurrent archs amplify bf16 ulps with depth (RG-LRU's decay is
# exp(-8 softplus(lambda) r) of a bf16 gate; xLSTM's mixers are exponentially
# gated), and a GEMM whose roundings depend on its row count (cuBLAS picks
# kernels by shape) parts a prefill of t-1 tokens, or a decode step, from the
# forward of t.  The reference itself, compiled on a CPU, breaks the elementwise
# bounds above at xlstm-350m's width from 16 layers on (prefill 1557 logits
# beyond 2e-2, decode relative error 0.041, run op by op 0.056, growing with
# depth).  So these archs are held by the relative (Frobenius) error of their
# logits instead
LM_RECURRENT_REL = 0.1
LM_MARGIN = 1e-2                      # a token is held only where the fused top-2 gap clears this
# the other block kinds (lm_blocks): each published config, cut where stated
BLOCKS_SERVED = ("recurrentgemma-2b", "xlstm-350m")    # every layer, served like lm_serve
BLOCKS_ENCDEC = "seamless-m4t-large-v2"                # every layer; the engine serves no frames
BLOCKS_DECODE_STEPS = 8
# full width, depth cut: the whole configs (107.8 B and 682.6 B parameters,
# 215.5 and 1365.3 GB in bf16) do not fit one 80 GB card
BLOCKS_MOE_CUTS = {
    "llama4-scout-17b-a16e": dict(num_layers=4),       # one repetition of its pattern
    "deepseek-v3-671b": dict(num_layers=2, prefix_kinds=("attn_dense_prefix",)),
}
BLOCKS_SMOKE = ("recurrentgemma-2b", "xlstm-350m", "llama4-scout-17b-a16e", "deepseek-v3-671b",
                "seamless-m4t-large-v2")
# card against CPU at full width: (arch, cuts, weights' dtype).  In bf16 the
# recurrences amplify the devices' ulp differences with depth -- the reference
# compiled against itself run op by op differs, relative, by 0.013, 0.031 and
# 0.095 at 4, 8 and 16 of xlstm-350m's layers (on a CPU), and the card against
# the CPU by 0.21 at its 24 -- so xlstm is held in bf16 at one repetition of its
# pattern and at its full size with every leaf cast to float32, where only
# float32 roundings are left to amplify
BLOCKS_CPU_CUTS = (
    ("recurrentgemma-2b", dict(num_layers=5), torch.bfloat16),   # 2 prefix layers + 1 repetition
    ("xlstm-350m", dict(num_layers=4), torch.bfloat16),          # one repetition
    ("xlstm-350m", {}, torch.float32),                           # full size
    ("seamless-m4t-large-v2", dict(num_layers=4, enc_layers=2, dec_layers=2), torch.bfloat16),
)
LM_F32_REL = 1e-3                     # float32 weights, card against CPU: relative error
MTP_BITS = 256                        # the MTP fusion's bayes_decide, at the gate's width
# the sort dispatch against the dense impl on one MoE layer's own bf16 weights:
# the same experts, their products summed in other orders (bmm over a padded
# capacity against a matmul per expert, the combine rounded per add against one
# einsum), so bf16 ulps of an output of scale 1
MOE_DISPATCH_TOL = (2e-2, 2e-2)
# MoE routing compared first (tests/test_torch_lm_models.py's bounds): a float32
# router logit summed in another order can move a near-tie and flip a token's
# experts; at most this share of the tokens, each at a top-k margin under this
ROUTE_SHARE, ROUTE_MARGIN = 0.125, 2e-2


# the training path (lm_train): phi3-mini-3.8b trained through TrainLoop at its
# published config, with the launcher's data and optimizer settings
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_STEPS = 6                       # step ms is the median of steps 2-5
TRAIN_TIMED = slice(2, TRAIN_STEPS)
TRAIN_BATCH, TRAIN_SEQ = 8, 128       # the launcher's --global-batch and --seq-len
TRAIN_CUT = dict(num_layers=2)        # card against CPU and the checkpoint cycle: full width
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 64
TRAIN_RESUME_STEPS = 4                # the checkpoint cycle: stop at 2, resume to 4
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 16
TRAIN_LAUNCH_STEPS = 20               # launch.train --smoke, card against CPU
TRAIN_EXAMPLE_STEPS = 6               # examples.train_lm card against CPU (the card alone: 60)
# one train step, card against CPU: cuBLAS and the CPU's GEMM sum the bf16
# products in other orders, so the gradients differ by bf16 ulps.  The loss
# within TRAIN_LOSS_ATOL.  The first AdamW step moves a weight by about lr
# times the sign of its gradient, so a gradient near zero that rounds to the
# other sign moves it the other way: the new params within one bf16 ulp but
# for at most TRAIN_FLIP_SHARE of them, all within 2 lr, and so the float32
# master; m and v within TRAIN_STATE_REL, the relative Frobenius error over
# the whole state (v is a square).  phi3 at full width, 2 layers, on an
# H100: loss 2.1e-4 apart, 0.63 % of the params apart (at most 1.997 lr),
# m and v 0.011 and 0.015
TRAIN_LOSS_ATOL = 2e-2
TRAIN_FLIP_SHARE = 2e-2
TRAIN_STATE_REL = {"m": 5e-2, "v": 1e-1}
# launch.train and train_lm, card against CPU: every step's loss within this
# (the trajectories part by bf16 ulps each step)
TRAIN_TRAJ_ATOL = 5e-2
TRAIN_MIN_FREE_BYTES = 14e9           # twice the ~7 GB the checkpoint cycle writes
# the full-size restore writes the params and the master (8 bytes a parameter,
# bf16 stored as float32) and holds them on the host while it writes: room for
# this many times that on the disk and in host memory.  The whole state (16
# bytes a parameter, 61 GB) passes the 45 GiB a chip machine lets a run write.
TRAIN_RESTORE_ROOM = 1.1
BF16_ULP = 2.0 ** -7


class _StepTimer:
    """While active: CUDA events at the start of each train step's loss, and
    around its optimizer update, and the update's grad norm."""

    def __enter__(self):
        self.marks, self.norms = [], []
        self._loss, self._apply = api.loss, adamw.apply
        rec = self

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def loss(*args, **kw):
            rec.marks.append([event()])
            return rec._loss(*args, **kw)

        def apply(*args, **kw):
            rec.marks[-1].append(event())
            out = rec._apply(*args, **kw)
            rec.marks[-1].append(event())
            rec.norms.append(out[2]["grad_norm"])
            return out
        api.loss, adamw.apply = loss, apply
        return self

    def __exit__(self, *exc):
        api.loss, adamw.apply = self._loss, self._apply

    def split(self):
        """Per step: forward+backward ms, optimizer ms, and the period to the
        next step's start (host time included; None for the last)."""
        torch.cuda.synchronize()
        out = []
        for i, (e0, e1, e2) in enumerate(self.marks):
            nxt = self.marks[i + 1][0] if i + 1 < len(self.marks) else None
            out.append({"fwd_bwd_ms": e0.elapsed_time(e1), "opt_ms": e1.elapsed_time(e2),
                        "period_ms": None if nxt is None else e0.elapsed_time(nxt)})
        return out


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[(n - 1) // 2] + xs[n // 2]) / 2


def _state_of(model, opt):
    """A train state on the CPU: {name: float32 param}, and m, v, master."""
    return ({n: p.detach().float().cpu() for n, p in model.named_parameters()},
            {f: {k: t.cpu() for k, t in getattr(opt, f).items()} for f in ("m", "v", "master")})


def _hold_step(what, card, cpu, lr, routed_alike=True):
    """One train step's results, card against CPU: the loss (TRAIN_LOSS_ATOL),
    every new param and master value (TRAIN_FLIP_SHARE beyond one bf16 ulp,
    all within 2 lr), and m and v (TRAIN_STATE_REL over the whole state).
    Where an MoE token went to another expert on one side (``routed_alike``
    False), that expert's gradient moves its weights the other way: every
    value is still held within 2 lr, but not the share beyond one ulp."""
    (pg, og, mg), (pc, oc, mc) = card, cpu
    loss_diff = abs(mg["loss"].item() - mc["loss"].item())
    if not (np.isfinite(mg["loss"].item()) and loss_diff <= TRAIN_LOSS_ATOL):
        raise AssertionError(f"{what}: loss {mg['loss'].item()} on the card against "
                             f"{mc['loss'].item()} on the CPU")
    out = {"loss_card": mg["loss"].item(), "loss_cpu": mc["loss"].item(), "loss_diff": loss_diff,
           "grad_norm_card": mg["grad_norm"].item(), "grad_norm_cpu": mc["grad_norm"].item()}
    named = [(n, a.detach(), b.detach()) for (n, a), (_, b)
             in zip(pg.named_parameters(), pc.named_parameters(), strict=True)]
    for part, leaves in (("params", named),
                         ("master", [(k, og.master[k], oc.master[k]) for k in oc.master])):
        flips = total = 0
        worst = 0.0
        for n, a, b in leaves:
            if a.dtype != b.dtype:
                raise AssertionError(f"{what}: {n} is {a.dtype} on the card, {b.dtype} on the CPU")
            a, b = a.float().cpu(), b.float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{what}: non-finite {part} {n}")
            diff = (a - b).abs()
            flips += int((diff > BF16_ULP * b.abs()).sum())
            total += diff.numel()
            over = float((diff - BF16_ULP * b.abs()).max()) / lr
            worst = max(worst, over)
            if over > 2 * 1.01:
                raise AssertionError(f"{what}: {part} {n} {over:.3f} lr beyond one bf16 ulp "
                                     f"from the CPU's")
        if routed_alike and flips > TRAIN_FLIP_SHARE * total:
            raise AssertionError(f"{what}: {flips} of {total} {part} beyond noise")
        out.update({f"{part}_apart": flips, f"{part}_values": total,
                    f"{part}_worst_lr": worst})
    for field, bound in TRAIN_STATE_REL.items():
        err = ref = 0.0
        for k, want in getattr(oc, field).items():
            err += float((getattr(og, field)[k].cpu() - want).square().sum())
            ref += float(want.square().sum())
        rel = (err / max(ref, 1e-300)) ** 0.5
        if rel > bound:
            raise AssertionError(f"{what}: {field} relative error {rel} beyond {bound}")
        out[f"{field}_rel"] = rel
    return out


def _bit_sums(tree):
    """Per tensor of ``(model, {name: tensor})``: the sum of its bit patterns
    and their sum weighted by position mod 65521, in int64 (exact, and
    independent of the order of summation), as one CPU tensor.  It tells a
    restored state from the one saved without a second copy on the card."""
    model, named = tree
    sums = []
    for t in [p.detach() for p in model.parameters()] + list(named.values()):
        bits = t.reshape(-1).view({2: torch.int16, 4: torch.int32}[t.element_size()])
        bits = bits.to(torch.int64)
        w = torch.arange(bits.numel(), device=t.device, dtype=torch.int64).remainder_(65521).add_(1)
        sums += [bits.sum(), bits.mul_(w).sum()]
        del bits, w
    return torch.stack(sums).cpu()


def _timed_restore(ckpt, marks):
    """Wraps ``ckpt.restore``: its seconds and the card memory it adds over
    what was allocated before it (``restore_s``, ``restore_added_bytes``),
    and the template's largest tensor as float32 (``restore_leaf_bytes``;
    the optimizer's leaves have the params' shapes)."""
    restore = ckpt.restore

    def timed(template, step=None):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = restore(template, step)
        torch.cuda.synchronize()
        marks["restore_s"] = time.perf_counter() - t0
        marks["restore_added_bytes"] = torch.cuda.max_memory_allocated() - before
        marks["restore_leaf_bytes"] = 4 * max(p.numel() for p in template[0].parameters())
        return out
    ckpt.restore = timed


def _hold_restore_memory(what, marks):
    """A restore in place adds at most one float32 leaf (the host array on its
    way to a bf16 tensor) to the card, plus the allocator's rounding."""
    if marks["restore_added_bytes"] > marks["restore_leaf_bytes"] + (8 << 20):
        raise AssertionError(f"{what}: the restore added {marks['restore_added_bytes']} bytes "
                             f"to the card, beyond one float32 leaf "
                             f"({marks['restore_leaf_bytes']} bytes)")


def _disk_and_memory(path):
    """Free bytes where ``path`` lies and the host's available memory."""
    free = shutil.disk_usage(path).free
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return {"disk_free_bytes": free, "mem_available_bytes": avail}


def _close(what, got, want, tol):
    """Float logits within ``tol`` -- (atol, rtol) elementwise, or a float: the
    relative Frobenius error -- of the other run's; returns the max abs diff."""
    got, want = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite logits")
    diff = (got - want).abs()
    if isinstance(tol, float):     # a bound of the relative error
        rel = float(diff.norm() / want.norm())
        if rel > tol:
            raise AssertionError(f"{what}: relative error {rel} beyond {tol}; max abs diff "
                                 f"{float(diff.max())}")
        return float(diff.max())
    bad = diff > tol[0] + tol[1] * want.abs()
    if bool(bad.any()):
        i = int(torch.nonzero(bad.reshape(-1))[0])
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} logits beyond {tol}; "
                             f"first at flat index {i}: {got.reshape(-1)[i].item()!r} against "
                             f"{want.reshape(-1)[i].item()!r}; max abs diff {float(diff.max())}, "
                             f"relative {float(diff.norm() / want.norm())}")
    return float(diff.max())


def _lm_batch(cfg, dev, seq=12, batch=2, seed=3):
    """Seeded tokens (and the vlm's patch or the audio model's frame
    embeddings) on ``dev``."""
    r = np.random.default_rng(seed)
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (batch, seq))).to(dev)
    extra = None
    if cfg.frontend in ("patch", "frame"):     # the vlm's patches, the audio encoder's frames
        n = LM_PATCHES if cfg.frontend == "patch" else seq // cfg.enc_ratio
        extra = torch.from_numpy(r.standard_normal((batch, n, cfg.d_model))
                                 .astype(np.float32)).to(dev)
    return toks, extra


def _gate_same(what, engine_cfg, keys, logits):
    """The engine's gate on the same logits and keys on the CPU and on the card:
    tokens, confidences, accept flags and the bayes_decide counts bit-equal.
    Returns the largest difference of the candidate posteriors, in float32 ulp."""
    gates = {}
    for dev in ("cpu", "cuda"):
        outs = []
        for key, lg in zip(keys, logits):
            lg = lg.to(dev)
            tok, conf, ok = engine_mod.emission_gate(engine_cfg, key, lg, device=dev)
            temp = torch.full((), engine_cfg.ensemble_temp, device=dev)
            _, p = bayes_head._candidates(torch.stack([lg, lg / temp]), 8, dev)
            _, counts = bayes_decide(key, p, engine_cfg.gate_n_bits, device=dev)
            outs.append([t.cpu() for t in (tok, conf, ok, counts, p)])
        gates[dev] = outs
    p_ulps = 0
    for step, (a, b) in enumerate(zip(gates["cuda"], gates["cpu"])):
        for name, x, y in zip(("token", "confidence", "accept", "counts"), a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{what} step {step}: the gate's {name} differs between "
                                     f"the card and the CPU: {x.tolist()} against {y.tolist()}")
        p_ulps = max(p_ulps, int((a[4].view(torch.int32) - b[4].view(torch.int32)).abs().max()))
    return p_ulps


def _fused_gap(logits, temp):
    """Per row, the gap between the top two fused candidate posteriors (analytic)."""
    src = torch.stack([logits, logits / torch.full((), temp, device=logits.device)])
    _, _, fused = bayes_head.fuse_posteriors(src, top_k=8, device=logits.device)
    top2 = torch.topk(fused, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu()


def _free_card():
    """Drop what the last model left on the card and reset the peak counter."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _init_on_card(cfg):
    """``api.init`` from PRNGKey(0) on the card: (params, its seconds, peak and size)."""
    _free_card()
    t0 = time.perf_counter()
    params = api.init(cfg, prng.PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    return params, {"init_s": time.perf_counter() - t0,
                    "init_peak_bytes": torch.cuda.max_memory_allocated(),
                    "params": api.param_count(params),
                    "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters())}


def _forward(model, cfg, toks, extra):
    """Teacher-forced logits of either family."""
    if cfg.family == "audio":
        return encdec.forward(model, cfg, extra, toks)[0]
    return transformer.forward(model, cfg, toks, extra)[0]


def _batch_of(toks, extra):
    return {"tokens": toks} | ({} if extra is None else {"extra_embeds": extra})


def _consistency(params, cfg, routes=None):
    """Decode after prefill of t-1 tokens against the teacher-forced forward at
    t (tests/models/test_smoke_archs.py's bounds); with a ``_Routes`` recorder,
    on the rows whose routing the two runs share (see ``_Routes.held``)."""
    toks, extra = _lm_batch(cfg, "cuda")
    n = LM_PATCHES if cfg.frontend == "patch" else 0
    rows = torch.arange(toks.shape[0])
    with torch.inference_mode():
        full = _forward(params, cfg, toks, extra)
        lp, st = api.prefill(params, cfg, _batch_of(toks[:, :-1], extra), 16 + n)
        ld, _ = api.decode(params, cfg, toks[:, -1], st, toks.shape[1] - 1 + n)
    out = {}
    if routes is not None:
        rows, out["routing"] = routes.held(cfg, toks.shape[0])
    out["prefill"] = _close("prefill vs forward", lp[rows], full[rows, -2],
                            _tol(cfg, LM_PREFILL_TOL))
    out["decode"] = _close("decode vs forward", ld[rows], full[rows, -1], _tol(cfg, LM_DECODE_TOL))
    out["relative"] = {name: float((a.float() - b.float()).norm() / b.float().norm())
                       for name, a, b in (("prefill", lp[rows], full[rows, -2]),
                                          ("decode", ld[rows], full[rows, -1]))}
    return out


def _tol(cfg, tol):
    """``tol``, or LM_RECURRENT_REL for a recurrent arch."""
    return LM_RECURRENT_REL if any(k in ("rec", "mlstm", "slstm") for k in cfg.pattern) else tol


class _Routes:
    """Records the expert ids and router logits of every MoE router call while
    active, for runs of one model whose routing should agree."""

    def __enter__(self):
        self.calls, self._probs = [], moe._router_probs
        rec = self

        def probs(logits, kind, k):
            out = rec._probs(logits, kind, k)
            rec.calls.append((logits.detach().float().cpu(), out[1].cpu()))
            return out
        moe._router_probs = probs
        return self

    def __exit__(self, *exc):
        moe._router_probs = self._probs

    def held(self, cfg, rows):
        """A forward, then a prefill of t-1 tokens and its decode, recorded in
        that order: their routing compared token for token (``_route_agreement``)."""
        n = len(self.calls) // 3
        fw, pre, dec = self.calls[:n], self.calls[n:2 * n], self.calls[2 * n:]
        return _route_agreement(cfg, rows, [(f[0], f[1], _join_calls(p, d, rows)[1])
                                            for f, p, d in zip(fw, pre, dec)])


def _join_calls(pre, dec, rows):
    """A prefill's router call and its decode's, as one call over each row's tokens."""
    return tuple(torch.cat([p.reshape(rows, -1, p.shape[-1]), d.reshape(rows, -1, d.shape[-1])],
                           1).reshape(-1, p.shape[-1]) for p, d in zip(pre, dec))


def _route_agreement(cfg, rows, calls):
    """Router calls of two runs of one model, layer by layer: (logits of run a,
    ids of run a, ids of run b), tokens flat row-major.  A token at or past its
    row's first disagreement in an earlier layer has another input by then;
    before it, a disagreement must be a near-tie (the least gap between
    adjacent scores among run a's first k + 1 under ROUTE_MARGIN), and at most
    ROUTE_SHARE of the tokens may disagree.  Returns (rows that agree
    throughout, report)."""
    first, n_tok, bad, margins = None, 0, 0, []
    for la, ia, ib in calls:
        s = ia.shape[0] // rows
        if first is None:
            first = torch.full((rows,), s)
        clean = (torch.arange(s)[None, :] < first[:, None]).reshape(-1)
        differ = (ia != ib).any(-1) & clean
        n_tok, bad = n_tok + int(clean.sum()), bad + int(differ.sum())
        if bool(differ.any()):
            scores = torch.sigmoid(la) if cfg.moe.router == "sigmoid" else torch.softmax(la, -1)
            top = torch.sort(scores, -1, descending=True)[0][:, : cfg.moe.top_k + 1]
            margin = (top[:, :-1] - top[:, 1:]).amin(-1)[differ]
            margins += margin.tolist()
            if bool((margin >= ROUTE_MARGIN).any()):
                raise AssertionError(f"{cfg.name}: expert ids differ at top-k margins "
                                     f"{margin.tolist()} (not near-ties)")
        d = differ.reshape(rows, s)
        first = torch.minimum(first, torch.where(d.any(1), d.int().argmax(1), s))
    if bad > ROUTE_SHARE * max(n_tok, 1):
        raise AssertionError(f"{cfg.name}: expert ids differ at {bad} of {n_tok} tokens")
    held = torch.arange(rows) if first is None else torch.nonzero(first == s)[:, 0]
    if len(held) == 0:
        raise AssertionError(f"{cfg.name}: no row routes alike in both runs")
    return held, {"tokens": n_tok, "differ": bad, "margins": margins, "rows_held": len(held)}


class _GateRecorder:
    """Records every emission-gate call of every ServeEngine while active:
    (key, logits, token, conf, ok)."""

    def __enter__(self):
        self.calls, self._gate = [], engine_mod.emission_gate
        rec = self

        def gate(ecfg, key, last_logits, *, device="cuda"):
            out = rec._gate(ecfg, key, last_logits, device=device)
            rec.calls.append((np.array(key), last_logits.detach().clone(), *out))
            return out
        engine_mod.emission_gate = gate
        return self

    def __exit__(self, *exc):
        engine_mod.emission_gate = self._gate


def _hold_lm_runs(what, card_calls, cpu_calls, temp):
    """Two runs of one serve, card and CPU, step by step: logits within
    LM_DECODE_TOL, tokens equal, until the first step whose tokens differ at a
    near tie (fused top-2 gap under LM_MARGIN on the CPU's logits), where the two
    contexts part and the comparison ends.  Returns (steps held, steps in all)."""
    if len(card_calls) != len(cpu_calls):
        raise AssertionError(f"{what}: {len(card_calls)} gate calls on the card, "
                             f"{len(cpu_calls)} on the CPU")
    for step, (a, b) in enumerate(zip(card_calls, cpu_calls)):
        _close(f"{what} step {step} logits", a[1], b[1], LM_DECODE_TOL)
        differ = a[2].cpu() != b[2].cpu()
        if bool(differ.any()):
            gap = _fused_gap(b[1], temp)
            if bool((gap[differ] >= LM_MARGIN).any()):
                raise AssertionError(f"{what} step {step}: tokens {a[2].tolist()} on the card "
                                     f"against {b[2].tolist()} where the fused gap "
                                     f"{gap.tolist()} clears {LM_MARGIN}")
            return step, len(cpu_calls)
    return len(cpu_calls), len(cpu_calls)


# --------------------------------------------------------------------------- multi_device
MD_RANKS = 2                  # ranks sharing a single card, over gloo
MD_SHARED = "cpu:gloo,cuda:gloo"    # NCCL takes no two ranks on one GPU
MD_NCCL = "cpu:gloo,cuda:nccl"
MD_TIMEOUT = 480              # seconds for the whole world
MD_GROUP_TIMEOUT = 180        # seconds a rank waits in a collective
MD_MOE_ARCH, MD_MOE_TOKENS = "llama4-scout-17b-a16e", (2, 256)
MD_MOE_TOL = (2e-2, 2e-2)     # (atol, rtol), bf16: EP against the local path
MD_LOSS_ARCH, MD_LOSS_LAYERS, MD_LOSS_TOKENS = "phi3-mini-3.8b", 2, (2, 256)
MD_LOSS_RTOL = 1e-3           # the sharded loss against the unsharded one
MD_PIPE_D, MD_PIPE_M, MD_PIPE_B = 3072, 6, 4   # phi3's width, the reference test's schedule
MD_PIPE_TOL = 1e-5
MD_CM_ROWS = 3072             # compressed_mean: a (3072, 3072) weight's gradient, rows split


def _md_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _md_sync():
    torch.cuda.synchronize()
    torch.distributed.barrier()


def _md_best_s(fn, reps=5):
    fn()
    best = float("inf")
    for _ in range(reps):
        _md_sync()
        t0 = time.perf_counter()
        fn()
        _md_sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _md_sweep(rep, n):
    """The 7 scenarios at B=1024, n_bits=4096 sharded over the world, run and
    decide bit-equal to the single launch of the same plan; an odd batch;
    launches per rank; frames/s sharded and single."""
    key = prng.PRNGKey(0)
    out = rep["sweep"] = {"per_scenario": {}}
    launches = odd_launches = 0
    for name in NAMES:
        spec = _spec(name)
        ev = torch.from_numpy(_evidence(spec, BATCH, 7)).cuda()
        single = compile_network(spec, n_bits=N_BITS, devices=1, device="cuda")
        shard = compile_network(spec, n_bits=N_BITS, devices=n, device="cuda")
        assert shard.n_shards == n, (name, shard.n_shards)
        net_sweep_kernel.net_sweep_cuda.launches = 0
        got = shard.run(key, ev) + shard.decide(key, ev)
        torch.cuda.synchronize()
        launches += net_sweep_kernel.net_sweep_cuda.launches
        want = single.run(key, ev) + single.decide(key, ev)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: the sharded sweep differs from the single launch")
        net_sweep_kernel.net_sweep_cuda.launches = 0
        odd = shard.run(key, ev[:BATCH - 1])
        torch.cuda.synchronize()
        odd_launches += net_sweep_kernel.net_sweep_cuda.launches
        for g, w in zip(odd, single.run(key, ev[:BATCH - 1])):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: the odd batch differs from the single launch")
        out["per_scenario"][name] = {"frames": BATCH, "shard_frames": BATCH // n}
    out["launches_per_rank"] = launches
    out["odd_launches_per_rank"] = odd_launches
    spec = _spec(TIMED_SCENARIO)
    ev = torch.from_numpy(_evidence(spec, BATCH, 7)).cuda()
    single = compile_network(spec, n_bits=N_BITS, devices=1, device="cuda")
    shard = compile_network(spec, n_bits=N_BITS, devices=n, device="cuda")
    out["single_fps"] = BATCH / _md_best_s(lambda: single.run(prng.PRNGKey(0), ev))
    out["sharded_fps"] = BATCH / _md_best_s(lambda: shard.run(prng.PRNGKey(0), ev))


def _md_example(rep, n):
    """``examples.sharded_sweep.run`` at its own size."""
    from repro_torch.examples import sharded_sweep

    r = sharded_sweep.run("cuda")
    if not r["identical"] or r["drained"] != r["frames"]:
        raise AssertionError(f"sharded_sweep: identical={r['identical']}, "
                             f"drained {r['drained']} of {r['frames']}")
    rep["example"] = {k: r[k] for k in ("frames", "n_shards", "single_fps", "sharded_fps",
                                        "drained", "drain_s")}


def _md_moe(rep, mesh):
    """llama4-scout's MoE layer at its published width (16 experts of 8192,
    top-1, a shared expert): local against expert parallel over `model`."""
    from repro_torch.distributed import context as dctx

    cfg = get_config(MD_MOE_ARCH)
    t0 = time.perf_counter()
    mp = moe.moe_init(prng.PRNGKey(2), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    x = prng.normal(prng.PRNGKey(3), MD_MOE_TOKENS + (cfg.d_model,), device="cuda")
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        xt = x.reshape(-1, cfg.d_model)
        ids = moe._router_probs(xt.float() @ mp["router"], cfg.moe.router, cfg.moe.top_k)[1]
        local, _ = moe.moe_apply(mp, x, cfg)
        with dctx.mesh_context(mesh):
            ep, _ = moe.moe_apply(mp, x, cfg)
            t_ep = _md_best_s(lambda: moe.moe_apply(mp, x, cfg), reps=3)
        t_local = _md_best_s(lambda: moe.moe_apply(mp, x, cfg), reps=3)
    # the expert ids first: the EP path routes this rank's tokens by the same router
    ids_ep = moe._router_probs(xt.float() @ mp["router"], cfg.moe.router, cfg.moe.top_k)[1]
    if not torch.equal(ids, ids_ep):
        raise AssertionError("moe: expert ids differ")
    err = _md_err(ep, local)
    atol, rtol = MD_MOE_TOL
    if not torch.allclose(ep.float(), local.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"moe: EP against local max abs err {err}")
    leaf_gb = sum(mp[k].numel() * mp[k].element_size() for k in ("wi", "wg", "wo")) / 1e9
    rep["moe"] = {"arch": MD_MOE_ARCH, "tokens": list(MD_MOE_TOKENS), "experts": cfg.moe.num_experts,
                  "expert_leaves_gb": leaf_gb, "init_s": init_s, "max_abs_err": err,
                  "tol": list(MD_MOE_TOL), "ep_ms": t_ep * 1e3, "local_ms": t_local * 1e3}
    del mp


def _md_loss(rep, mesh):
    """phi3-mini-3.8b at full width cut to 2 layers: the loss with params
    placed by ``param_shardings`` under the mesh against the unsharded loss."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding

    cfg = dataclasses.replace(get_config(MD_LOSS_ARCH), num_layers=MD_LOSS_LAYERS)
    params = api.init(cfg, prng.PRNGKey(0), device="cuda")
    n_params = api.param_count(params)
    r = np.random.default_rng(5)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, MD_LOSS_TOKENS)).cuda()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with torch.no_grad():
        plain = float(api.loss(params, cfg, batch)[0])
        sharding.distribute_params(params, mesh)
        bs = {k: sharding.shard(v, mesh, sharding.batch_sharding(mesh)) for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dctx.mesh_context(mesh):
            sharded = api.loss(params, cfg, bs)[0].full_tensor()
        sharded = float(sharded)
        loss_s = time.perf_counter() - t0
    rel = abs(sharded - plain) / abs(plain)
    if not (np.isfinite(sharded) and rel <= MD_LOSS_RTOL):
        raise AssertionError(f"loss: sharded {sharded} against {plain} (rel {rel})")
    rep["loss"] = {"arch": MD_LOSS_ARCH, "layers": MD_LOSS_LAYERS, "params": n_params,
                   "tokens": list(MD_LOSS_TOKENS), "plain": plain, "sharded": sharded,
                   "rel_err": rel, "rtol": MD_LOSS_RTOL, "sharded_s": loss_s}
    del params


def _md_pipeline(rep, mesh):
    """GPipe, a stage per rank at phi3's width, against the unpipelined oracle."""
    from repro_torch.distributed.pipeline import pipeline_forward, reference_forward

    g = torch.Generator().manual_seed(11)
    d, n = MD_PIPE_D, mesh.shape[0]
    params = {"w1": (torch.randn(n, d, 2 * d, generator=g) * 0.02).cuda(),
              "w2": (torch.randn(n, 2 * d, d, generator=g) * 0.02).cuda()}
    x = torch.randn(MD_PIPE_M, MD_PIPE_B, d, generator=g).cuda()

    def stage_fn(p, h):
        return h + layers.gelu(h @ p["w1"]) @ p["w2"]

    with torch.no_grad():
        t0 = time.perf_counter()
        got = pipeline_forward(stage_fn, params, x, mesh)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        want = reference_forward(stage_fn, params, x)
    err = _md_err(got, want)
    if not torch.allclose(got, want, atol=MD_PIPE_TOL, rtol=MD_PIPE_TOL):
        raise AssertionError(f"pipeline: max abs err {err}")
    rep["pipeline"] = {"d": d, "stages": n, "microbatches": MD_PIPE_M, "max_abs_err": err,
                       "tol": MD_PIPE_TOL, "pipeline_s": pipe_s}


def _md_compressed(rep, mesh):
    """compressed_mean over `data`: per rank, bit for bit the codes of both
    shards summed in float32 times this rank's own scale over n."""
    from repro_torch.optim import compression

    g = torch.Generator().manual_seed(12)
    grad = (torch.randn(MD_CM_ROWS, MD_PIPE_D, generator=g) * 0.01).cuda()
    n = mesh.shape[0]
    rows = MD_CM_ROWS // n
    d = mesh.get_local_rank("data")
    shards = [{"w": grad[i * rows:(i + 1) * rows]} for i in range(n)]
    zero = {"w": torch.zeros_like(shards[0]["w"])}
    key = prng.PRNGKey(0)
    mean, res = compression.compressed_mean(key, shards[d], zero, "data", mesh)
    enc = [compression.compress(key, sh, zero) for sh in shards]
    total = sum(q["w"].to(torch.float32) for q, _, _ in enc)
    want = total * enc[d][1]["w"] / n
    if not (torch.equal(mean["w"], want) and torch.equal(res["w"], enc[d][2]["w"])):
        raise AssertionError("compressed_mean differs from the codes' sum")
    rep["compressed_mean"] = {"shape": [MD_CM_ROWS, MD_PIPE_D], "axis": "data", "ranks": n,
                              "bit_equal": True}


MD_STEPS = {   # step -> (function, mesh shape as a function of the world's ranks, axis names)
    "sweep": (_md_sweep, None, None),
    "example": (_md_example, None, None),
    "moe": (_md_moe, lambda n: (1, n), ("data", "model")),
    "loss": (_md_loss, lambda n: (1, n), ("data", "model")),
    "pipeline": (_md_pipeline, lambda n: (n,), ("pod",)),
    "compressed_mean": (_md_compressed, lambda n: (n,), ("data",)),
}
def _md_worlds(cards):
    """(tag, ranks, backend, steps) of the worlds to run.  One rank per card
    over NCCL where the machine has several cards.  On one card, 2 ranks
    share it over gloo, and the sharded loss runs at 1 rank over NCCL: gloo
    kills the process on CUDA tensors in the functional all_gather that
    DTensor's Shard -> Replicate uses (SIGSEGV; c10d's all_gather works),
    and refuses send/recv (writev: Bad address)."""
    if cards > 1:
        return (("nccl", cards, MD_NCCL, tuple(MD_STEPS)),)
    return (("gloo", MD_RANKS, MD_SHARED, tuple(k for k in MD_STEPS if k != "loss")),
            ("nccl", 1, MD_NCCL, ("loss",)))


def _md_rank(rank, n, tmp, backend_name, steps):
    """One rank of a multi_device world: the named steps on this rank's view."""
    from datetime import timedelta

    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend_name, init_method=f"file://{tmp}/init", rank=rank, world_size=n,
        timeout=timedelta(seconds=MD_GROUP_TIMEOUT))
    rep = {"rank": rank}
    try:
        for step in steps:
            fn, shape, names = MD_STEPS[step]
            args = (n,) if shape is None else \
                (init_device_mesh("cuda", shape(n), mesh_dim_names=names),)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn(rep, *args)
            _md_sync()
            rep.setdefault(step, {}).update(seconds=time.perf_counter() - t0,
                                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        (pathlib.Path(tmp) / f"rank{rank}.json").write_text(json.dumps(rep, default=str))
    finally:
        torch.distributed.destroy_process_group()


def _md_world(n, backend_name, steps):
    """Spawn a world of ``n`` ranks on the card; each rank's report, in rank
    order.  A rank that fails, or a world past ``MD_TIMEOUT``, raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="multi_device_") as tmp:
        ctx = mp.spawn(_md_rank, args=(n, tmp, backend_name, steps), nprocs=n, join=False)
        deadline = time.monotonic() + MD_TIMEOUT
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"multi_device: the world passed {MD_TIMEOUT} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]


# --------------------------------------------------------------------------- dryrun
# production cells of the H100-cluster dry run: (arch, shape, --mesh)
DRYRUN_CELLS = (("phi3-mini-3.8b", "train_4k", "both"),
                ("llama4-scout-17b-a16e", "decode_32k", "single"),
                ("deepseek-v3-671b", "prefill_32k", "single"),
                ("deepseek-v3-671b", "train_4k", "single"),
                ("recurrentgemma-2b", "prefill_32k", "single"),
                ("xlstm-350m", "train_4k", "single"),
                ("paper-bayes-fusion", "train_4k", "single"))
DRYRUN_TIMEOUT = 420          # seconds for each dry-run process
# archs whose cells trace for minutes on one CPU core (xlstm's sLSTM: some 15
# fake ops per token, each traced forward, recomputed and backward): started
# when the script starts, while the GPU phases run, under a timeout of their own
DRYRUN_EARLY, DRYRUN_EARLY_TIMEOUT = {"xlstm-350m"}, 900
DRYRUN_FIT_GB = 80            # the cells of DRYRUN_FIT must fit an H100's HBM per GPU
DRYRUN_FIT = ("phi3-mini-3.8b__train_4k__h100x32x8", "deepseek-v3-671b__train_4k__h100x32x8",
              "recurrentgemma-2b__prefill_32k__h100x32x8")
SLSTM_TRACE_SEQ = 1024        # a quarter of train_4k's sequence
# One sLSTM layer of xlstm-350m at full width (the model cut to that one
# block), a train step traced on rank 0 of the h100x32x8 fake world at
# train_4k's batch (8 rows per GPU), at each sequence length given; prints
# {seq: seconds}.  Run as ``python -c`` with a tree's own ``src`` first on
# the path, so the same measurement reads another checkout's code.
SLSTM_TRACE = """
import dataclasses, json, sys, time
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

cfg = dataclasses.replace(get_config("xlstm-350m"), pattern=("slstm",), num_layers=1)
out = {}
with dryrun.fake_world(256):
    mesh = make_production_mesh(device="cuda")
    for seq in map(int, sys.argv[1:]):
        t0 = time.perf_counter()
        dryrun._measure(cfg, ShapeConfig("slstm", seq, 256, "train"), mesh, "xlstm-350m")
        out[seq] = time.perf_counter() - t0
print(json.dumps(out))
"""


def slstm_trace_cmd(tree, seqs):
    """The command that runs SLSTM_TRACE on the checkout ``tree``."""
    return [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(pathlib.Path(tree) / 'src')!r})"
            + SLSTM_TRACE, *map(str, seqs)]
# fake against real on the card: phi3 at full width cut to 2 layers, at
# lm_train's batch, one rank with no mesh
DRYRUN_ARCH, DRYRUN_CUT = "phi3-mini-3.8b", dict(num_layers=2)
DRYRUN_PEAK_SHARE = 0.10      # the fake peak within this share of max_memory_allocated


def _dryrun_cells(out):
    """The CLI command of each DRYRUN_CELLS entry, by ``arch__shape__mesh``."""
    return {f"{a}__{s}__{m}": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                               "--shape", s, "--mesh", m, "--out", str(out)]
            for a, s, m in DRYRUN_CELLS}


def _roofline_terms(counts):
    """(compute, memory) seconds of a count at the data sheet's peaks."""
    return counts["flops"] / BF16_PEAK_FLOPS, counts["bytes"] / HBM_BYTES_PER_S


def _dryrun_on_card(out_path):
    """The dry run's counts against what runs on the card, in a process of
    its own: (b) one train step of phi3 at full width cut to 2 layers at
    lm_train's batch, counted on real CUDA tensors and counted fake (FLOPs
    and bytes equal, the fake peak within DRYRUN_PEAK_SHARE of
    ``max_memory_allocated``), a second step timed with CUDA events; (c)
    whole phi3 at lm_train's batch on one GPU, counted fake: the forward and
    backward apart from the optimizer, the memory terms beside lm_train's
    measured times.  Writes its report to ``out_path``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = ShapeConfig("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    cfg = dataclasses.replace(get_config(DRYRUN_ARCH), **DRYRUN_CUT)
    rep = {"shape": [TRAIN_BATCH, TRAIN_SEQ], "layers": cfg.num_layers}
    t0 = time.perf_counter()
    fake = dryrun_mod._measure(cfg, shape, None, DRYRUN_ARCH, device="cuda")
    rep["fake_s"] = time.perf_counter() - t0
    params = api.init(cfg, prng.PRNGKey(0), device="cuda")
    batch = {k: torch.zeros(spec.shape, dtype=spec.dtype, device="cuda")
             for k, spec in dryrun_mod.input_specs(DRYRUN_ARCH, shape, cfg).items()}
    args = (params, adamw.init(params), batch)
    step = dryrun_mod.make_train_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    real = roofline.counts_of(dryrun_mod.count_step(step, args))
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step(*args)
    end.record()
    torch.cuda.synchronize()
    rep.update(fake={k: fake[k] for k in ("flops", "bytes", "peak_bytes", "params_bytes",
                                          "optimizer_bytes")},
               real={k: real[k] for k in ("flops", "bytes", "peak_bytes")},
               base_bytes=base, max_memory_allocated=real_peak,
               step_ms=start.elapsed_time(end))
    rep["compute_s"], rep["memory_s"] = _roofline_terms(fake)
    del params, args, batch
    gc.collect()
    torch.cuda.empty_cache()
    # (c) whole phi3 at lm_train's batch, one GPU: the forward+backward alone,
    # then the whole step; the optimizer is the difference
    whole = get_config(DRYRUN_ARCH)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step_w, args_w = dryrun_mod.build_step(whole, shape, None, DRYRUN_ARCH, device="cuda")
        params_w, _, batch_w = args_w

        def fwd_bwd(p, b):
            loss, _ = api.loss(p, whole, b)
            torch.autograd.grad(loss, list(p.parameters()))

        grads = roofline.counts_of(dryrun_mod.count_step(fwd_bwd, (params_w, batch_w)))
        total = roofline.counts_of(dryrun_mod.count_step(step_w, args_w))
    rep["whole"] = {"seconds": time.perf_counter() - t0,
                    "fwd_bwd": {k: grads[k] for k in ("flops", "bytes")},
                    "optimizer": {k: total[k] - grads[k] for k in ("flops", "bytes")},
                    "step": {k: total[k] for k in ("flops", "bytes", "peak_bytes")}}
    for part in ("fwd_bwd", "optimizer", "step"):
        c = rep["whole"][part]
        c["compute_ms"], c["memory_ms"] = (t * 1e3 for t in _roofline_terms(c))
    pathlib.Path(out_path).write_text(json.dumps(rep))


class Smoke:
    def __init__(self):
        self.failures = []
        self.report = {"phases": {}}
        self.card = ""
        self.early = {}          # name -> (process, log path, deadline) of the early dry-run cells

    def start_dryrun_early(self):
        """Start the dry-run cells of DRYRUN_EARLY, each a CLI process that
        writes its log to a file; ``dryrun`` reads them."""
        out = ROOT / "chiprun_out" / "dryrun"
        out.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for name, cmd in _dryrun_cells(out).items():
            if name.split("__")[0] in DRYRUN_EARLY:
                log = out / f"{name}.log"
                with open(log, "w") as f:
                    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                            stderr=subprocess.STDOUT, text=True)
                self.early[name] = (proc, log, time.monotonic() + DRYRUN_EARLY_TIMEOUT)

    def stop(self):
        """Stop every process the run started and left running."""
        for proc, _, _ in self.early.values():
            proc.kill()
            proc.wait()

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

    def _kernel_cases(self):
        """(name, noise, epochs, n_bits, B, frame0, total) of the kernels phase."""
        cases = [(n, None, 1, N_BITS, BATCH, 0, None) for n in NAMES]
        cases += [(n, NoiseModel.nominal(), 3, N_BITS, BATCH, 0, None) for n in NOISY]
        cases += [("intersection-cat", None, 1, N_BITS, BATCH, 2**27 + 5, 2**28)]
        cases += [(n, None, 1, 128, BATCH, 0, None) for n in NAMES]
        cases += [("wide", None, 1, N_BITS, BATCH, 0, None)]
        return cases

    def build(self):
        """One nvcc per kernel source and per net_sweep program, all started together."""
        plans = {_plan(n, noise, ep) for n, noise, ep, *_ in self._kernel_cases()}
        plans |= {sweep_plan(spec, spec.queries, spec.evidence)       # the examples' own networks
                  for spec in (route_planning.SPEC, scene_graph.MOTIF)}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES) + len(plans)) as pool:
            libs = {name: pool.submit(backend.build_library, mod.SOURCE,
                                      deps=getattr(mod, "DEPS", ()))
                    for name, mod in LIBRARIES.items()}
            progs = pool.submit(net_sweep_kernel.prepare, sorted(plans, key=repr))
            built = {name: f.result() for name, f in libs.items()}
            progs.result()
        wall = time.perf_counter() - t0
        for name, (path, log) in built.items():
            print(f"{path.name}:\n{log.strip()}", flush=True)
            LIBRARIES[name].library()
        try:
            self.report["node_mux_sass"] = _node_mux_sass(built["node_mux"][0])
            for kind, c in sorted(self.report["node_mux_sass"].items()):
                print(f"node_mux_binary_kernel {kind}: SASS {c['total']} instructions, integer "
                      f"{c['alu']} ALU-only + {c['muladd']} multiply/add ({c['prmt']} PRMT, "
                      f"{c['imad']} IMAD)", flush=True)
        except (OSError, subprocess.SubprocessError, AssertionError) as e:
            print(f"node_mux SASS not counted ({type(e).__name__}: {e})", flush=True)
        sne_sass = self.report["sne_sass"] = {}
        for name in ("sne_encode", "bayes_decide"):
            try:
                c = sne_sass[name] = _sne_sass(built[name][0], f"{name}_kernel")
                per = "not counted (no hash copy found)" if not c["hash_copies"] else \
                    f"{c['alu_per_hash']:.1f} ALU + {c['muladd_per_hash']:.1f} multiply/add"
                print(f"{name}_kernel: SASS {c['total']} instructions, integer {c['alu']} "
                      f"ALU-only + {c['muladd']} multiply/add, {c['hash_copies']} hash copies; "
                      f"per copy {per}; counted least per entropy word {SNE_ALU_OPS} ALU + "
                      f"{SNE_MULADD_OPS} multiply/add", flush=True)
            except (OSError, subprocess.SubprocessError, AssertionError) as e:
                print(f"{name} SASS not counted ({type(e).__name__}: {e})", flush=True)
        programs = dict(net_sweep_kernel.BUILDS)
        self.sass = {}
        for info in programs.values():
            regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
            try:
                self.sass[info["source"]] = _sass_ops(info["library"])
                sass = "SASS integer instructions {} ALU + {} multiply/add".format(
                    *self.sass[info["source"]])
            except (OSError, subprocess.SubprocessError, AssertionError) as e:
                sass = f"SASS not counted ({type(e).__name__}: {e})"
            print(f"{info['source']}: nvcc {info['seconds']:.2f} s; {' '.join(regs)}; {sass}",
                  flush=True)
        secs = [info["seconds"] for info in programs.values()]
        print(f"built {len(built)} kernel libraries and {len(programs)} net_sweep programs "
              f"(for {len(plans)} plans) in {wall:.1f} s; nvcc per program "
              f"{min(secs):.2f}-{max(secs):.2f} s", flush=True)
        self.report["build_log"] = {name: log for name, (_, log) in built.items()}
        self.report["net_sweep_programs"] = {
            info["source"]: {"nvcc_s": info["seconds"], "log": info["log"],
                             "sass_alu_muladd": self.sass.get(info["source"])}
            for info in programs.values()}
        self.report["build_wall_s"] = wall

    def kernels(self):
        self.max_err = 0
        checked = 0
        for name, noise, epochs, n_bits, b, frame0, total in self._kernel_cases():
            plan = _plan(name, noise, epochs)
            ev = torch.from_numpy(_evidence(_spec(name), b, seed=n_bits + epochs)).cuda()
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
        print(f"net_sweep: {checked} launches of the generated programs bit-equal to the "
              f"plain version (max abs err {self.max_err}; tolerance 0: integer counts and "
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
        builds = net_sweep_kernel.net_sweep_cuda.builds
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
        if net_sweep_kernel.net_sweep_cuda.builds != builds:
            raise AssertionError("a net_sweep program was built during the main path: "
                                 "compile_network must build it")
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
        w = N_BITS // 32
        for n in NAMES:
            spec = by_name(n)
            plan = _plan(n)
            prog = record_program(plan)
            sass = self.sass.get(f"net_sweep_{net_sweep_kernel.program_key(plan)}.cu")
            # the least work per item: the gate program's LOP3-aware count, or
            # the built kernel's SASS where ptxas needed fewer instructions
            alu, total = prog.alu_ops_per_word, prog.int_ops_per_word
            if sass is not None:
                alu, total = min(alu, sass[0]), min(total, sum(sass))
            rows[n] = {"int_ops_per_word": prog.int_ops_per_word,
                       "alu_ops_per_word": prog.alu_ops_per_word, "sass_alu_muladd": sass,
                       "bound_ops_per_word": total, "bound_alu_ops_per_word": alu,
                       "gates": len(prog.code), "live_words": prog.n_slots}
            for b in (BATCH, MAX_BATCH):
                ev = torch.from_numpy(_evidence(spec, b, seed=7)).cuda()

                def launch():
                    return net_sweep_kernel.net_sweep_cuda(*KD, ev, plan=plan, n_bits=N_BITS)

                ms, call_ms = _device_ms(launch), _event_ms(launch, reps=50)
                items = b * w
                clocks = items * max(alu / INT32_LANES_PER_SM, total / DISPATCH_LANES_PER_SM)
                op_ms = clocks / (self.n_sm * self.max_clock_mhz * 1e6) * 1e3
                nbytes = ev.numel() * 4 + b * prog.n_out * 4
                byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(op_ms, byte_ms)
                row = {"ms": ms, "call_ms": call_ms, "int_ops": total * items,
                       "alu_ops": alu * items, "bytes": nbytes, "bound_ms": bound,
                       "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                       "x_bound": ms / bound}
                if b == BATCH:
                    row["plain_ms"] = _event_ms(
                        lambda: sweep_tile(plan, *KD, ev, 0, 0, b, w, w, b), reps=3, warmup=1)
                rows[n][b] = row
                plain = f", plain {row['plain_ms']:.3f} ms" if "plain_ms" in row else ""
                sass_txt = "SASS not counted" if sass is None else \
                    f"SASS {sass[0]} ALU + {sass[1]} multiply/add"
                self.say(f"net_sweep {n}: B={b} n_bits={N_BITS}: kernel {ms:.4f} ms/launch "
                         f"on the device, {call_ms:.4f} ms per back-to-back call{plain}, "
                         f"bound {bound:.4f} ms ({ms / bound:.2f}x; per word {total} int ops, "
                         f"{alu} on the ALU alone; program {prog.int_ops_per_word} / "
                         f"{prog.alu_ops_per_word}, {sass_txt}; {len(prog.code)} gates, "
                         f"{prog.n_slots} live words)")
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

    def drain_trace(self):
        """One async drain under torch.profiler: device busy share, kernel time by name."""
        from torch.profiler import ProfilerActivity, profile

        net = compile_network(by_name(TIMED_SCENARIO), n_bits=N_BITS, device="cuda")
        frames = _evidence(by_name(TIMED_SCENARIO), DRAIN_FRAMES, seed=23)
        warm = FrameDriver(net, max_batch=MAX_BATCH, salt=600)
        warm.submit(frames)
        warm.drain_async()
        d = FrameDriver(net, max_batch=MAX_BATCH, salt=601)
        d.submit(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = d.drain_async()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        assert len(out) == DRAIN_FRAMES
        busy, n_spans = _busy_us(prof)
        by_name_us = {}
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us:
                by_name_us[e.key] = dev_us
        top = sorted(by_name_us.items(), key=lambda kv: -kv[1])[:8]
        trace_path = ROOT / "chiprun_out" / "drain_trace.json"
        trace_path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        if not n_spans:
            raise AssertionError("torch.profiler recorded no device activity in the drain")
        self.say(f"drain trace ({TIMED_SCENARIO}, {DRAIN_FRAMES} frames, max_batch={MAX_BATCH}, "
                 f"torch.profiler): wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
                 f"({busy / wall_us * 100:.1f}% of the window, the union of {n_spans} device "
                 f"intervals); device time by name: "
                 + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
        self.report["drain_trace"] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us, "device_intervals": n_spans,
            "device_ms_by_name": {k: v / 1e3 for k, v in by_name_us.items()},
            "trace": str(trace_path.relative_to(ROOT)),
        }

    # --------------------------------------------------------------- router
    def router(self):
        """The multi-tenant BayesRouter at its own defaults, card against CPU."""
        self.report["router"] = {}
        self._router_parity()
        self._router_chaos()
        self._router_overload()
        self._router_timed()
        self._router_recalibration()
        self._router_fit()

    def _router_parity(self):
        wl = _router_workload(ROUTER_PARITY_FRAMES, seed=31)
        cpu = _router(RouterPolicy(), MAX_BATCH, "cpu")
        cpu_rids, _, _ = _router_round(cpu, wl, ROUTER_LONG_MS)
        card = _router(RouterPolicy(), MAX_BATCH, "cuda")
        builds = net_sweep_kernel.net_sweep_cuda.builds
        torch.cuda.synchronize()
        _reset_launches()                                      # the router's path starts
        rids, _, wall = _router_round(card, wl, ROUTER_LONG_MS)
        torch.cuda.synchronize()
        counts = _launches()                                   # the router's path ends
        self.router_launches = counts["net_sweep"]
        if self.router_launches <= 0:
            raise AssertionError("the router's serve launched the net_sweep kernel 0 times")
        others = {k: v for k, v in counts.items() if k != "net_sweep" and v}
        if others:
            raise AssertionError(f"the router's path launched other kernels: {others}")
        if net_sweep_kernel.net_sweep_cuda.builds != builds:
            raise AssertionError("a net_sweep program was built during the router's serve")
        if rids != cpu_rids:
            raise AssertionError("the card router and the CPU router numbered rids apart")
        _router_same(card, cpu, rids, "parity")
        census = _census(card, rids)
        if census["OK"] != len(rids) or any(card.results[r].degrade_level for r in rids):
            raise AssertionError(f"the parity serve did not serve every frame at full "
                                 f"fidelity: {census}")
        for name in NAMES:                       # a tenant equals its standalone driver
            d = FrameDriver(compile_network(by_name(name), n_bits=N_BITS, device="cuda"),
                            max_batch=MAX_BATCH, base_key=ROUTER_KEY, salt=tenant_salt(name))
            d.submit(wl[name])
            ref = d.drain()
            mine = [r for r in rids if card.results[r].tenant == name]
            for i, rid in enumerate(mine):
                res = card.results[rid]
                if not np.array_equal(res.post, ref[i][0]) or res.accepted != ref[i][1]:
                    raise AssertionError(f"{name}: router rid {rid} differs from a standalone "
                                         f"driver with salt tenant_salt({name!r})")
        self.say(f"router parity: {len(NAMES)} tenants x {ROUTER_PARITY_FRAMES} frames, "
                 f"n_bits={N_BITS}, max_batch={MAX_BATCH}, chunks of {ROUTER_CHUNK}: card equal "
                 f"to the CPU rid for rid (status, posterior, accepted, level) and each tenant "
                 f"to a standalone card FrameDriver; net_sweep launches {self.router_launches}; "
                 f"serve {wall * 1e3:.1f} ms")
        self.report["router"]["parity"] = {"frames": len(rids), "launches": counts,
                                           "census": census, "wall_ms": wall * 1e3}

    def _router_chaos(self):
        wl = _router_workload(ROUTER_CHAOS_FRAMES, seed=41)
        runs = {}
        for device in ("cuda", "cpu"):
            r = _router(RouterPolicy(**FAST), ROUTER_CHAOS_BATCH, device,
                        fault=LaunchFaultInjector(**CHAOS))
            rids, out, wall = _router_round(r, wl, ROUTER_LONG_MS)
            runs[device] = (r, rids, wall)
        (card, rids, wall), (cpu, cpu_rids, _) = runs["cuda"], runs["cpu"]
        if rids != cpu_rids:
            raise AssertionError("the chaos routers numbered rids apart")
        _router_same(card, cpu, rids, "chaos")
        if card.fault.injected != cpu.fault.injected:
            raise AssertionError(f"chaos drew {card.fault.injected} on the card and "
                                 f"{cpu.fault.injected} on the CPU")
        census = _census(card, rids)
        trips = {n: card.tenant(n).trips for n in NAMES}
        self.say(f"router chaos ({CHAOS}, max_batch={ROUTER_CHAOS_BATCH}, "
                 f"{len(NAMES)} x {ROUTER_CHAOS_FRAMES} frames): card equal to the CPU rid for "
                 f"rid; injected {dict(card.fault.injected)}; census {census}; lost 0; "
                 f"breaker trips {sum(trips.values())}; serve {wall * 1e3:.1f} ms")
        self.report["router"]["chaos_parity"] = {
            "injected": dict(card.fault.injected), "census": census, "trips": trips,
            "wall_ms": wall * 1e3}

    def _router_overload(self):
        """The timed overload round's shape, held card against CPU: rung 1 for every frame."""
        wl = _router_workload(ROUTER_OVERLOAD_FRAMES, seed=51)
        cpu = _router(RouterPolicy(), MAX_BATCH, "cpu")
        cpu_rids, _, _ = _router_round(cpu, wl, ROUTER_LONG_MS)
        card = _router(RouterPolicy(), MAX_BATCH, "cuda")
        builds = net_sweep_kernel.net_sweep_cuda.builds
        torch.cuda.synchronize()
        _reset_launches()                                      # the overload serve starts
        rids, _, wall = _router_round(card, wl, ROUTER_LONG_MS)
        torch.cuda.synchronize()
        counts = _launches()                                   # the overload serve ends
        if counts["net_sweep"] <= 0:
            raise AssertionError("the overload serve launched the net_sweep kernel 0 times")
        others = {k: v for k, v in counts.items() if k != "net_sweep" and v}
        if others:
            raise AssertionError(f"the overload serve launched other kernels: {others}")
        if net_sweep_kernel.net_sweep_cuda.builds != builds:
            raise AssertionError("a net_sweep program was built during the overload serve")
        if rids != cpu_rids:
            raise AssertionError("the overload routers numbered rids apart")
        _router_same(card, cpu, rids, "overload")
        census = _census(card, rids)
        if census["DEGRADED"] != len(rids) or any(card.results[r].degrade_level != 1
                                                  for r in rids):
            raise AssertionError(f"the overload serve did not serve every frame DEGRADED at "
                                 f"rung 1: {census}")
        rung_bits = card.tenant(NAMES[0]).drivers[1].net.n_bits
        self.say(f"router overload parity: {len(NAMES)} tenants x {ROUTER_OVERLOAD_FRAMES} "
                 f"frames, max_batch={MAX_BATCH}: every frame DEGRADED at rung 1 ({rung_bits} "
                 f"bits), card equal to the CPU rid for rid; net_sweep launches "
                 f"{counts['net_sweep']}; serve {wall * 1e3:.1f} ms")
        self.report["router"]["overload_parity"] = {
            "frames": len(rids), "rung_n_bits": rung_bits, "launches": counts,
            "census": census, "wall_ms": wall * 1e3}

    def _router_timed(self):
        from torch.profiler import ProfilerActivity, profile

        rows = {}
        for mode, n in ROUTER_MODES.items():
            chaos = mode == "chaos"
            r = _router(RouterPolicy(**FAST) if chaos else RouterPolicy(),
                        ROUTER_CHAOS_BATCH if chaos else MAX_BATCH, "cuda",
                        fault=LaunchFaultInjector(**CHAOS) if chaos else None)
            wl = _router_workload(n, seed=51)
            _router_round(r, wl, ROUTER_LONG_MS)            # warm-up: plans, rungs
            torch.cuda.synchronize()
            builds = net_sweep_kernel.net_sweep_cuda.builds
            launches = net_sweep_kernel.net_sweep_cuda.launches
            walls, census, hits, frames = [], collections.Counter(), 0, 0
            levels = collections.Counter()
            for _ in range(ROUTER_ROUNDS):
                rids, _, wall = _router_round(r, wl)           # the default 1 s deadline
                walls.append(wall)
                census.update(_census(r, rids))
                levels.update(r.results[rid].degrade_level for rid in rids)
                hits += sum(r.results[rid].deadline_met for rid in rids)
                frames += len(rids)
            torch.cuda.synchronize()
            built = net_sweep_kernel.net_sweep_cuda.builds - builds
            if built:
                raise AssertionError(f"router {mode}: {built} net_sweep programs built "
                                     f"during the timed rounds")
            per_round = len(NAMES) * n
            row = {"frames_per_round": per_round, "rounds": ROUTER_ROUNDS,
                   "wall_ms": [w * 1e3 for w in walls],
                   "frames_per_s_best_round": per_round / min(walls),
                   "frames_per_s_all_rounds": frames / sum(walls), "census": dict(census),
                   "levels": dict(levels), "lost": 0, "deadline_hit_rate": hits / frames,
                   "launches": net_sweep_kernel.net_sweep_cuda.launches - launches,
                   "builds": built}
            if chaos:
                row["injected"] = dict(r.fault.injected)
            if mode == "nominal":
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    rids, _, _ = _router_round(r, wl)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                busy, n_spans = _busy_us(prof)
                if not n_spans:
                    raise AssertionError("torch.profiler recorded no device activity in "
                                         "the router's round")
                row.update(traced_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                           busy_share=busy / wall_us, device_intervals=n_spans)
            rows[mode] = row
            extra = (f"; one traced round: wall {row['traced_wall_ms']:.1f} ms, device busy "
                     f"{row['device_busy_ms']:.3f} ms ({row['busy_share'] * 100:.2f}% of the "
                     f"window)") if mode == "nominal" else ""
            inj = f"; injected {row['injected']}" if chaos else ""
            self.say(f"router {mode}: {len(NAMES)} x {n} frames per round, {ROUTER_ROUNDS} "
                     f"rounds: {row['frames_per_s_best_round']:.0f} frames/s in the best "
                     f"round, {row['frames_per_s_all_rounds']:.0f} frames/s over all rounds "
                     f"(rounds "
                     + ", ".join(f"{w * 1e3:.1f}" for w in walls)
                     + f" ms); census {dict(census)}; levels {dict(levels)}; lost 0; deadline "
                     f"hit rate {row['deadline_hit_rate']:.4f}; net_sweep launches "
                     f"{row['launches']}, builds 0{inj}{extra}")
        self.report["router"]["timed"] = rows

    def _router_recalibration(self):
        spec = by_name(RECAL_TENANT)
        ev = analytic.sample_evidence(spec, prng.PRNGKey(61), 3 * RECAL_FRAMES,
                                      device="cpu").numpy()
        runs = {}
        for device in ("cuda", "cpu"):
            r = _router(RouterPolicy(), MAX_BATCH, device, drift=tbn.DriftPolicy(warmup=2))
            r.register(RECAL_TENANT, noise=NoiseModel(seed=9, cycle=0, wear_tau=1.0))
            t = r.tenant(RECAL_TENANT)
            swap = {}
            recalibrate = t.recalibrate

            def timed(cycle=None, recalibrate=recalibrate, swap=swap):
                before = set(net_sweep_kernel.BUILDS)
                t0 = time.perf_counter()
                c = recalibrate(cycle)
                swap["wall_s"] = time.perf_counter() - t0
                swap["nvcc_s"] = [net_sweep_kernel.BUILDS[k]["seconds"]
                                  for k in set(net_sweep_kernel.BUILDS) - before]
                return c

            t.recalibrate = timed
            before = set(net_sweep_kernel.BUILDS)
            t0 = time.perf_counter()
            rids = r.submit(RECAL_TENANT, ev[:RECAL_FRAMES], deadline_ms=ROUTER_LONG_MS)
            r.drain()
            first_s = time.perf_counter() - t0
            first_nvcc = [net_sweep_kernel.BUILDS[k]["seconds"]
                          for k in set(net_sweep_kernel.BUILDS) - before]
            t.monitor.state = tbn.HEALTH_RECALIBRATING          # force the latch
            for lo in (RECAL_FRAMES, 2 * RECAL_FRAMES):   # the swap round, then the twin serves
                rids += r.submit(RECAL_TENANT, ev[lo:lo + RECAL_FRAMES],
                                 deadline_ms=ROUTER_LONG_MS)
                r.drain()
            if sorted(r.results) != sorted(rids):
                raise AssertionError(f"recalibration on {device} lost frames")
            if t.recalibrations != 1 or r.health(RECAL_TENANT) != tbn.HEALTH_HEALTHY:
                raise AssertionError(f"recalibration on {device}: {t.recalibrations} swaps, "
                                     f"health {r.health(RECAL_TENANT)}")
            if t.drivers[0].net.program is None:
                raise AssertionError("the swapped-in plan is not a calibrate-back twin")
            runs[device] = (r, rids, swap, first_s, first_nvcc)
        (card, rids, swap, first_s, first_nvcc), (cpu, cpu_rids, *_) = runs["cuda"], runs["cpu"]
        if rids != cpu_rids:
            raise AssertionError("the recalibration routers numbered rids apart")
        _router_same(card, cpu, rids, "recalibration")
        census = _census(card, rids)
        if census["OK"] != len(rids):
            raise AssertionError(f"recalibration census {census}")
        if len(swap["nvcc_s"]) != 1:
            raise AssertionError(f"the recalibration built {len(swap['nvcc_s'])} net_sweep "
                                 f"programs, not one")
        self.say(f"router recalibration ({RECAL_TENANT}, NoiseModel(seed=9, wear_tau=1.0), "
                 f"n_bits={N_BITS}, max_batch={MAX_BATCH}, 3 x {RECAL_FRAMES} frames): card "
                 f"equal to the CPU rid for rid, 1 recalibration at cycle "
                 f"{card.tenant(RECAL_TENANT).drivers[0].net.noise.cycle}, health HEALTHY, "
                 f"lost 0; hot swap {swap['wall_s'] * 1e3:.1f} ms in the pump, of which nvcc "
                 f"{swap['nvcc_s'][0] * 1e3:.1f} ms for the twin's net_sweep library; first "
                 f"serve of the noisy tenant {first_s * 1e3:.1f} ms (nvcc "
                 + ", ".join(f"{x * 1e3:.1f}" for x in first_nvcc) + " ms)")
        self.report["router"]["recalibration"] = {
            "swap_wall_ms": swap["wall_s"] * 1e3, "twin_nvcc_ms": swap["nvcc_s"][0] * 1e3,
            "first_serve_ms": first_s * 1e3, "first_plan_nvcc_ms": [x * 1e3 for x in first_nvcc],
            "census": census}

    def _router_fit(self):
        reps, ms = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            reps[device] = tbn.calibration_report(prng.PRNGKey(0), n_scenes=48, repeats=3,
                                                  device=device)
            ms[device] = (time.perf_counter() - t0) * 1e3
        if reps["cuda"] != reps["cpu"]:
            raise AssertionError("calibration_report differs between the card and the CPU")
        rep = reps["cuda"]
        self.say(f"calibration_report(PRNGKey(0), n_scenes=48, repeats=3): card {ms['cuda']:.1f} "
                 f"ms, CPU {ms['cpu']:.1f} ms, equal; max DAC deviation "
                 f"{rep['max_dac_deviation']}; fitted means "
                 + ", ".join(f"{f} {v['mean']:.4f}" for f, v in rep["fields"].items()))
        self.report["router"]["calibration_report"] = {"ms": ms, "report": rep}

    # ------------------------------------------------- the reliable decision path
    def _run_flows(self, phase, flows):
        """Each flow on the CPU; then one nvcc per net_sweep program that the
        CPU runs' plans need, all started together; then each flow on the card,
        launch counts reset just before and read just after, no program built
        in between, and each card result held against its CPU twin.  Returns
        ({label: card result}, {label: report row}, net_sweep launches)."""
        cpu, rows = {}, {}
        for label, fn in flows.items():
            t0 = time.perf_counter()
            cpu[label] = fn("cpu")
            rows[label] = {"cpu_s": time.perf_counter() - t0}
        plans = {p for r in cpu.values() for p in r["meta"]["plans"]}
        programs = {net_sweep_kernel.program_key(p) for p in plans}
        before = set(net_sweep_kernel.BUILDS)
        t0 = time.perf_counter()
        net_sweep_kernel.prepare(sorted(plans, key=repr))
        wall = time.perf_counter() - t0
        nvcc = [net_sweep_kernel.BUILDS[k]["seconds"]
                for k in sorted(set(net_sweep_kernel.BUILDS) - before)]
        span = f"{min(nvcc):.2f}-{max(nvcc):.2f} s, {sum(nvcc):.1f} s in all" if nvcc else "none"
        self.say(f"{phase}: {len(plans)} plans, {len(programs)} net_sweep programs, {len(nvcc)} "
                 f"built here (the rest by earlier phases) in {wall:.1f} s, one nvcc each, all "
                 f"started together; nvcc per program {span}")
        builds = net_sweep_kernel.net_sweep_cuda.builds
        card = {}
        torch.cuda.synchronize()
        _reset_launches()                                      # the phase's path starts
        for label, fn in flows.items():
            n0 = net_sweep_kernel.net_sweep_cuda.launches
            t0 = time.perf_counter()
            card[label] = fn("cuda")
            torch.cuda.synchronize()
            rows[label].update(card_s=time.perf_counter() - t0,
                               launches=net_sweep_kernel.net_sweep_cuda.launches - n0)
        counts = _launches()                                   # the phase's path ends
        if net_sweep_kernel.net_sweep_cuda.builds != builds:
            raise AssertionError(f"{phase}: {net_sweep_kernel.net_sweep_cuda.builds - builds} "
                                 f"net_sweep programs built during the card's flows")
        if counts["net_sweep"] <= 0:
            raise AssertionError(f"{phase}: the flows launched the net_sweep kernel 0 times")
        others = {k: v for k, v in counts.items() if k != "net_sweep" and v}
        if others:
            raise AssertionError(f"{phase}: the flows launched other kernels: {others}")
        oracle_err = 0.0
        for label in flows:
            held_equal(card[label], cpu[label], f"{phase} {label}, card against CPU")
            if "oracle" in cpu[label]["meta"]:
                oracle_err = max(oracle_err, float(np.abs(
                    card[label]["meta"]["oracle"] - cpu[label]["meta"]["oracle"]).max()))
        if oracle_err > ORACLE_ATOL:
            raise AssertionError(f"{phase}: the oracle's posteriors differ card against CPU "
                                 f"by {oracle_err} > {ORACLE_ATOL}")
        self.report[phase] = {"plans": len(plans), "programs": len(programs), "built": len(nvcc),
                              "nvcc_s": nvcc, "build_wall_s": wall, "launches": counts,
                              "oracle_max_abs_err": oracle_err, "flows": rows}
        return card, rows, counts["net_sweep"]

    def _flow_say(self, label, row, text):
        self.say(f"{label}: {text}; card {row['card_s']:.2f} s, CPU {row['cpu_s']:.2f} s, "
                 f"net_sweep launches {row['launches']}; card equal to the CPU")

    def reliability(self):
        """bench_reliability's flows on the card, held against the CPU and
        gated by check_bench's limits."""
        flows = {f"flip {n}": (lambda dev, n=n: flip_curves(n, dev)) for n in NAMES}
        flows.update({f"retry {n} {m}": (lambda dev, n=n, m=m: retry_race(n, dev, m))
                      for n in REL_RETRY_NAMES for m in ("sync", "async")})
        card, rows, self.rel_launches = self._run_flows("reliability", flows)
        top, bad = max(REL_NBITS), []
        for n in NAMES:
            label = f"flip {n}"
            r, row = card[label], rows[label]
            row.update(flip_scale={s: v["flip"] for s, v in r["scale"].items()},
                       flip_n_bits={b: v["flip"] for b, v in r["n_bits"].items()})
            ok = r["n_bits"][top]["flip"] <= MAX_NOMINAL_FLIP
            bad += [] if ok else [label]
            self._flow_say(label, row, f"{REL_FRAMES} frames, flip rate against the clean oracle "
                           f"at {REL_SCALE_BITS} bits by noise scale "
                           + ", ".join(f"{s}x {v:.4f}" for s, v in row["flip_scale"].items())
                           + "; nominal by n_bits "
                           + ", ".join(f"{b} {v:.4f}" for b, v in row["flip_n_bits"].items())
                           + f" (limit {MAX_NOMINAL_FLIP} at {top}: {'ok' if ok else 'FAILED'})")
        for label in (f"retry {n} {m}" for n in REL_RETRY_NAMES for m in ("sync", "async")):
            r, row = card[label], rows[label]
            st = r["stats"]
            ok = r["retry"]["flip"] <= r["flat"]["flip"] and r["overhead"] <= MAX_RETRY_OVERHEAD
            bad += [] if ok else [label]
            row.update(flip_retry=r["retry"]["flip"], flip_flat=r["flat"]["flip"],
                       mean_bits=st["total_bits"] / st["frames"], flat_bits=r["flat_bits"],
                       overhead=r["overhead"], retry_rate=st["retries"] / st["frames"],
                       unreliable=st["unreliable"], escalations=st["escalations"],
                       drain_s=r["meta"]["seconds"])
            self._flow_say(label, row, f"{REL_FRAMES} frames from {REL_RETRY_BITS} bits, "
                           f"RetryPolicy({REL_RETRY}): flip retry {row['flip_retry']:.4f} vs flat "
                           f"{row['flip_flat']:.4f} at {row['flat_bits']} bits, bit overhead "
                           f"{row['overhead']:.3f}x (limit {MAX_RETRY_OVERHEAD}x: "
                           f"{'ok' if ok else 'FAILED'}), retry rate {row['retry_rate']:.4f}, "
                           f"unreliable {row['unreliable']}, final attempts {st['escalations']}; "
                           f"drains on the card {row['drain_s']['retry'] * 1e3:.1f} ms retry, "
                           f"{row['drain_s']['flat'] * 1e3:.1f} ms flat")
        if bad:
            raise AssertionError(f"reliability checks failed on the card: {bad}")

    def drift(self):
        """bench_drift's aging race and hot swap, and the drift monitor under
        the driver, on the card, held against the CPU and gated by
        check_bench's limits."""
        flows = {f"race {n}": (lambda dev, n=n: aging_race(n, dev)) for n in NAMES}
        flows["hot_swap"] = lambda dev: hot_swap(dev, SWAP_DELAY_CYCLES if dev == "cuda" else 0)
        flows.update({f"monitor {n} {m}": (lambda dev, n=n, noisy=noisy, m=m:
                                           monitor_run(n, noisy, m, dev))
                      for n, noisy in MONITOR_CASES for m in ("sync", "async")})
        card, rows, self.drift_launches = self._run_flows("drift", flows)
        wins, bad = 0, []
        for n in NAMES:
            label = f"race {n}"
            r, row = card[label], rows[label]
            ok = r["flip_closed"] <= r["flip_open"] + DRIFT_FLIP_TOL
            wins += r["flip_closed"] < r["flip_open"]
            bad += [] if ok else [label]
            row.update(flip_open=r["flip_open"], flip_closed=r["flip_closed"], recals=r["recals"],
                       trajectory=[dict(zip(("launch", "cycle", "flip_open", "flip_closed",
                                             "recals"), t)) for t in r["rows"]],
                       swap_ms=[s * 1e3 for s in r["meta"]["swap_s"]],
                       closed_drain_ms=[s * 1e3 for s in r["meta"]["closed_s"]])
            self._flow_say(label, row, f"{DRIFT_LAUNCHES} launches of {DRIFT_BATCH} frames at "
                           f"{DRIFT_BITS} bits, cycle 0-{r['rows'][-1][1]}: flip open / closed "
                           + ", ".join(f"{t[2]:.4f}/{t[3]:.4f}" for t in r["rows"])
                           + f"; final {r['flip_open']:.4f} vs {r['flip_closed']:.4f} "
                           f"({r['recals']} refits; closed <= open + {DRIFT_FLIP_TOL}: "
                           f"{'ok' if ok else 'FAILED'}); swap_net pairs "
                           f"{max(row['swap_ms']):.3f} ms at most; closed drain "
                           f"{min(row['closed_drain_ms']):.2f}-{max(row['closed_drain_ms']):.2f} ms")
        if wins < DRIFT_MIN_WINS:
            bad.append(f"strict wins {wins} < {DRIFT_MIN_WINS}")
        self.report["drift"]["strict_wins"] = wins
        r, row = card["hot_swap"], rows["hot_swap"]
        meta = r["meta"]
        pending_ok = len(meta["pending_at_swap"]) == 2 and all(meta["pending_at_swap"])
        if not pending_ok:
            bad.append(f"hot swap: launches pending at the swap {meta['pending_at_swap']}")
        if r["lost"] or not r["preserved"]:
            bad.append(f"hot swap: lost {r['lost']}, pre-swap frames preserved {r['preserved']}")
        nvcc = [net_sweep_kernel.BUILDS.get(net_sweep_kernel.program_key(p), {}).get("seconds")
                for p in meta["plans"]]
        row.update(lost=r["lost"], preserved=r["preserved"], pending_at_swap=meta["pending_at_swap"],
                   pending_after_swap=meta["pending_after_swap"], swap_ms=meta["swap_s"] * 1e3,
                   recalibrated_network_ms=meta["recal_s"] * 1e3, nvcc_s=nvcc)
        self._flow_say("hot_swap", row, f"{SWAP_NAME}, {SWAP_FRAMES} frames, max_batch "
                       f"{SWAP_BATCH}: swap_net to recalibrated_network(cycle={SWAP_CYCLE}) with "
                       f"both launches pending on the device (events incomplete at the swap "
                       f"{meta['pending_at_swap']}, after it {meta['pending_after_swap']}, behind "
                       f"{SWAP_DELAY_CYCLES} clocks of torch.cuda._sleep); swap {row['swap_ms']:.3f} "
                       f"ms, recalibrated_network {row['recalibrated_network_ms']:.1f} ms (its "
                       f"program built beforehand; nvcc of the two plans "
                       + ", ".join("not in this phase" if s is None else f"{s:.2f} s" for s in nvcc)
                       + f"); lost {r['lost']}, pre-swap frames equal to the twin's "
                       f"{r['preserved']}")
        for n, noisy in MONITOR_CASES:
            for m in ("sync", "async"):
                label = f"monitor {n} {m}"
                r, row = card[label], rows[label]
                row.update(states=[t[2] for t in r["trajectory"]], launches_driven=r["launches"])
                self._flow_say(label, row, f"{'noisy' if noisy else 'clean'}, {MONITOR_FRAMES} "
                               f"frames, {MONITOR_BITS} bits, max_batch {MONITOR_BATCH}: "
                               f"{r['launches']} launches, states "
                               + " ".join(s[0] for s in row["states"]))
        if bad:
            raise AssertionError(f"drift checks failed on the card: {bad}")

    # ------------------------------------------------------------ operators
    def paper_layer(self):
        """The paper-figure layer and the four examples at the reference's
        sizes: each flow on the CPU, then on the card with launch counts reset
        just before and read just after, held by PAPER_RULES."""
        report = self.report["paper_layer"] = {}
        builds = net_sweep_kernel.net_sweep_cuda.builds
        for flow, (fn, rules) in PAPER_FLOWS.items():
            cpu = fn("cpu")
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            card = fn("cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in _launches().items() if v}
            errs = _hold(flow, card, cpu, rules)
            row = report[flow] = {"card_s": secs, "launches": launches, "max_abs_diff": errs,
                                  "summary": card["summary"]}
            if flow == "encode_via_device":
                row["margin_rule"] = card["summary"]["margin_rule"] = _hold_via_device(card, cpu)
            if flow == "fig1":
                row["ou_card_s"] = card["ou_s"]
                row["ou_ms_per_step"] = card["ou_s"] / 20000 * 1e3
            exact = sum(r == _EXACT for r in rules.values())
            self.say(f"paper_layer {flow}: card {secs:.3f} s, launches {launches or 'none'}; "
                     f"card = CPU ({exact} results exact, {len(rules) - exact} within stated "
                     f"tolerances; max abs diff {max(errs.values(), default=0.0):.3g}); "
                     f"{json.dumps(card['summary'], default=str)}")
        if net_sweep_kernel.net_sweep_cuda.builds != builds:
            raise AssertionError("a net_sweep program was built inside the paper layer: "
                                 "the build phase must build the examples' programs")
        # the throughput model against the batched inference operator's rate
        p = torch.full((INFER_BATCH,), 0.57, device="cuda")

        def call():
            return inference.bayes_inference(PAPER_KEY, p, 0.72, 0.6, n_bits=INFER_BITS,
                                             device="cuda").posterior_ratio
        ms = _event_ms(call, reps=20)
        measured = INFER_BATCH / (ms * 1e-3)
        model = latency.throughput_model(self.int32_ops_per_s, n_bits=INFER_BITS)
        report["throughput"] = {"measured_decisions_per_s": measured, "ms_per_call": ms,
                                "model_decisions_per_s": model,
                                "int32_ops_per_s": self.int32_ops_per_s}
        self.say(f"throughput: batched bayes_inference ({INFER_BATCH} decisions at {INFER_BITS} "
                 f"bits, plain torch on the card) {ms:.3f} ms per call = {measured:,.0f} "
                 f"decisions/s; latency.throughput_model at {self.int32_ops_per_s / 1e12:.1f} T "
                 f"int32 ops/s predicts {model:,.0f} ({model / measured:.0f}x the measured rate)")

    # ------------------------------------------------------------ LM serving
    def lm_serve(self):
        """The LM serving path: phi3-mini-3.8b at its published config served
        through ServeEngine with the stochastic gate; card against CPU at full
        width cut to LM_CUT_LAYERS layers and for every arch of the slice at its
        smoke config; the launcher and the serve_lm example."""
        report = self.report["lm_serve"] = {}
        self._lm_full(report)
        self._lm_cut(report)
        report["smoke"] = self._smoke_card_vs_cpu("lm_serve", LM_ARCHS)
        self._lm_launcher(report)

    def _lm_full(self, report):
        cfg = get_config(LM_ARCH)
        params, init = _init_on_card(cfg)
        consistency = _consistency(params, cfg)
        served = self._serve(cfg, params)
        row = report["full"] = {"arch": LM_ARCH, "layers": cfg.num_layers, **init,
                                "consistency_max_abs_diff": consistency, **served}
        self.lm_gate = row["gate"]
        self.say(f"lm_serve {LM_ARCH} (full config, {cfg.num_layers} layers, {init['params']:,} "
                 f"params, {init['param_bytes'] / 1e9:.2f} GB): init {init['init_s']:.1f} s, peak "
                 f"{init['init_peak_bytes'] / 1e9:.2f} GB; prefill vs forward max diff "
                 f"{consistency['prefill']:.4f}, decode {consistency['decode']:.4f}")
        self._say_served("lm_serve", row)
        del params
        _free_card()

    def _serve(self, cfg, params):
        """LM_REQUESTS requests of 8-12 prompt tokens through ServeEngine at
        LM_ENGINE on ``params`` (on the card), counts reset just before and read
        just after; every step's gate input through bayes_decide held equal to
        its plain version, and its device time at the engine's shape."""
        engine = ServeEngine(cfg, params, LM_ENGINE, device="cuda")
        r = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=r.integers(0, cfg.vocab_size, size=int(r.integers(8, 13)))
                        .astype(np.int32), max_new_tokens=LM_NEW_TOKENS)
                for i in range(LM_REQUESTS)]
        events = {"prefill": [], "decode": []}

        def timed(name, fn):
            def call(*args):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args)
                e1.record()
                events[name].append((e0, e1))
                return out
            return call
        engine._prefill = timed("prefill", engine._prefill)
        engine._decode = timed("decode", engine._decode)
        torch.cuda.synchronize()
        _reset_launches()
        with _GateRecorder() as rec:
            t0 = time.perf_counter()
            engine.run(prng.PRNGKey(1), reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in _launches().items() if v}
        serve_peak = torch.cuda.max_memory_allocated()
        ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
        steps = len(rec.calls)
        emitted = sum(len(q.out_tokens) for q in reqs)
        for q in reqs:
            if not q.done or len(q.out_tokens) != LM_NEW_TOKENS:
                raise AssertionError(f"request {q.rid}: {len(q.out_tokens)} tokens, done={q.done}")
        late = sorted(q.rid for q in reqs if q.admit_step > 0)
        if len(late) != LM_REQUESTS - LM_ENGINE.max_batch:
            raise AssertionError(f"admitted mid-flight: {late}")
        if launches.get("bayes_decide", 0) != steps or steps == 0:
            raise AssertionError(f"{steps} gate calls, launches {launches}")
        for key, lg, *_ in rec.calls:
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError("non-finite logits reached the gate")
        # each step's gate input: the kernel against its plain version, bit for bit
        for step, (key, lg, tok, *_) in enumerate(rec.calls):
            temp = torch.full((), LM_ENGINE.ensemble_temp, device="cuda")
            cand, p = bayes_head._candidates(torch.stack([lg, lg / temp]), 8, "cuda")
            best, counts = bayes_decide(key, p, LM_ENGINE.gate_n_bits, device="cuda")
            pbest, pcounts = bayes_decide(key, p.cpu(), LM_ENGINE.gate_n_bits, device="cpu")
            if not (torch.equal(best.cpu(), pbest) and torch.equal(counts.cpu(), pcounts)):
                raise AssertionError(f"step {step}: bayes_decide differs from its plain version")
            if not torch.equal(torch.gather(cand, -1, best[:, None].long())[:, 0], tok):
                raise AssertionError(f"step {step}: the gate's token is not the kernel's decision")
        key0, lg0 = rec.calls[0][0], rec.calls[0][1]
        temp = torch.full((), LM_ENGINE.ensemble_temp, device="cuda")
        _, p0 = bayes_head._candidates(torch.stack([lg0, lg0 / temp]), 8, "cuda")
        gate = self._decide_timing(key0, p0, LM_ENGINE.gate_n_bits)
        gate["launches"] = steps
        gated = sum(c >= LM_ENGINE.confidence_threshold for q in reqs for c in q.confidences)
        dec = sorted(ms["decode"])
        return {"serve_peak_bytes": serve_peak, "prefill_ms": ms["prefill"],
                "decode_ms_median": dec[len(dec) // 2], "decode_ms_min": dec[0],
                "decode_ms_max": dec[-1], "decode_steps": len(dec), "serve_s": wall,
                "tokens": emitted, "tokens_per_s": emitted / wall, "gate_calls": steps,
                "launches": launches, "gated_share": gated / emitted, "late_admits": late,
                "gate": gate}

    def _decide_timing(self, key, p, n_bits):
        """bayes_decide at ``p``'s shape: device ms per launch, ms per back-to-back
        call and the bound."""
        kd = rng.seed_words(key)

        def launch():
            return bd_kernel.bayes_decide_cuda(*kd, p, n_bits=n_bits)
        bound, by, _, _, hashed = self._op_bound("bayes_decide", p, n_bits)
        return {"shape": list(p.shape), "n_bits": n_bits,
                "ms": _device_ms(launch, kernel="bayes_decide_kernel"),
                "call_ms": _event_ms(launch, 50), "bound_ms": bound, "bound_by": by,
                "hashed_share": hashed}

    def _say_served(self, phase, row):
        dec, gate = row, row["gate"]
        self.say(f"{phase} serve: {LM_REQUESTS} requests on {LM_ENGINE.max_batch} slots "
                 f"(rids {row['late_admits']} admitted mid-flight), {row['tokens']} tokens in "
                 f"{row['serve_s']:.3f} s = {row['tokens_per_s']:.1f} tokens/s; prefills (CUDA "
                 "events) " + ", ".join(f"{v:.2f}" for v in row["prefill_ms"]) + " ms; decode per "
                 f"step median {dec['decode_ms_median']:.2f} ms (min {dec['decode_ms_min']:.2f}, "
                 f"max {dec['decode_ms_max']:.2f}) over {dec['decode_steps']} steps; launches "
                 f"{row['launches']}; {row['gated_share']:.3f} of the emissions cleared the gate; "
                 f"serve peak {row['serve_peak_bytes'] / 1e9:.2f} GB")
        self.say(f"{phase} gate: bayes_decide at the engine's shape (M, B, K) = "
                 f"{tuple(gate['shape'])}, {gate['n_bits']} bits: {gate['ms']:.5f} ms/launch on "
                 f"the device, {gate['call_ms']:.4f} ms per back-to-back call, bound "
                 f"{gate['bound_ms']:.6f} ms ({gate['bound_by']}); equal to its plain version at "
                 f"all {gate['launches']} steps")

    def _lm_cut(self, report):
        """phi3 at full width, depth cut to LM_CUT_LAYERS, card against CPU."""
        cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_CUT_LAYERS)
        row = report["cut"] = self._card_vs_cpu(f"{LM_ARCH} x{LM_CUT_LAYERS}", cfg)
        self.say(f"lm_serve {LM_ARCH} at full width, {LM_CUT_LAYERS} layers, card against CPU: "
                 f"logits max abs diff per step {[round(e, 4) for e in row['max_abs_diff']]}; "
                 f"card greedy = CPU greedy {row['greedy_agree']}/{row['greedy_of']}; gate on the "
                 f"CPU's logits equal on both (candidate posteriors differ by up to "
                 f"{row['gate_p_max_ulps']} ulp)")

    def _card_vs_cpu(self, what, cfg, steps=8, dtype=torch.bfloat16):
        """Weights made on the card (cast to float32 if ``dtype`` asks), copied to the CPU; a
        prefill of 8 tokens and ``steps`` greedy decode steps on the CPU, the
        same tokens forced on the card; logits within LM_WIDE_TOL (a recurrent
        arch LM_RECURRENT_REL; float32 weights LM_F32_REL), the gate on the
        CPU's logits equal."""
        card = api.init(cfg, prng.PRNGKey(0), device="cuda")
        if dtype == torch.float32:       # every leaf; bf16 runs keep the float32 leaves
            card = card.float()
        cpu = copy.deepcopy(card).to("cpu")
        toks, extra = _lm_batch(cfg, "cpu", seq=8)
        n = 0 if extra is None or cfg.frontend == "frame" else extra.shape[1]
        logits = {"cpu": [], "cuda": []}
        forced = []
        with torch.inference_mode():
            for dev, model in (("cpu", cpu), ("cuda", card)):
                e = None if extra is None else extra.to(dev)
                lg, st = api.prefill(model, cfg, _batch_of(toks.to(dev), e), 32 + n)
                logits[dev].append(lg)
                for t in range(steps):
                    if dev == "cpu":
                        forced.append(torch.argmax(lg, -1))
                    lg, st = api.decode(model, cfg, forced[t].to(dev), st, toks.shape[1] + n + t)
                    logits[dev].append(lg)
        forced.append(torch.argmax(logits["cpu"][-1], -1))
        tol = LM_F32_REL if dtype == torch.float32 else _tol(cfg, LM_WIDE_TOL)
        errs = [_close(f"{what} step {i}", a, b, tol)
                for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"]))]
        rel = [float((a.cpu() - b).norm() / b.norm()) for a, b in zip(logits["cuda"], logits["cpu"])]
        agree = sum(int((torch.argmax(a.cpu(), -1) == b).sum())
                    for a, b in zip(logits["cuda"], forced))
        keys = [prng.fold_in(prng.PRNGKey(1), i) for i in range(len(logits["cpu"]))]
        p_ulps = _gate_same(what, LM_ENGINE, keys, logits["cpu"])
        del card, cpu
        _free_card()
        return {"layers": cfg.num_layers, "dtype": str(dtype)[6:], "max_abs_diff": errs,
                "relative": rel, "greedy_agree": agree,
                "greedy_of": len(forced) * toks.shape[0], "gate_p_max_ulps": p_ulps}

    def _smoke_card_vs_cpu(self, phase, archs):
        """Each arch at its smoke config, made on the card and copied to the CPU:
        forward, prefill and decode on both, the gate on the CPU's logits; the
        MoE archs' routing compared first (``_route_agreement``), the logits on
        the rows that route alike."""
        rows = {}
        for arch in archs:
            cfg = get_smoke_config(arch)
            card = api.init(cfg, prng.PRNGKey(0), device="cuda")
            cpu = copy.deepcopy(card).to("cpu")
            toks, extra = _lm_batch(cfg, "cpu")
            n_extra = 0 if extra is None or cfg.frontend == "frame" else extra.shape[1]
            out, routes = {}, {}
            with torch.inference_mode():
                for dev, model in (("cpu", cpu), ("cuda", card)):
                    t, e = toks.to(dev), None if extra is None else extra.to(dev)
                    with _Routes() as r:
                        fw = _forward(model, cfg, t, e)
                        lp, st = api.prefill(model, cfg, _batch_of(t[:, :-1], e), 16 + n_extra)
                        ld, _ = api.decode(model, cfg, t[:, -1], st, t.shape[1] - 1 + n_extra)
                    out[dev], routes[dev] = (fw, lp, ld), r.calls
            held = {"forward": torch.arange(2), "prefill": torch.arange(2)}
            errs = {}
            if cfg.moe:
                k = len(routes["cpu"]) // 3
                for part, calls in (("forward", range(k)), ("prefill", range(k, 3 * k))):
                    cpu_calls = [routes["cpu"][i] for i in calls]
                    card_calls = [routes["cuda"][i] for i in calls]
                    if part == "prefill":     # per layer, the prefill's tokens then the decode's
                        cpu_calls = [_join_calls(cpu_calls[i], cpu_calls[i + k], 2) for i in range(k)]
                        card_calls = [_join_calls(card_calls[i], card_calls[i + k], 2)
                                      for i in range(k)]
                    held[part], errs[f"routing_{part}"] = _route_agreement(
                        cfg, 2, [(a[0], a[1], b[1]) for a, b in zip(cpu_calls, card_calls)])
            for name, a, b, tol in zip(("forward", "prefill", "decode"), out["cuda"], out["cpu"],
                                       (LM_PREFILL_TOL, LM_PREFILL_TOL, LM_DECODE_TOL)):
                r = held["forward" if name == "forward" else "prefill"]
                errs[name] = _close(f"{arch} {name}", a[r.to(a.device)], b[r], tol)
            keys = [prng.fold_in(prng.PRNGKey(2), i) for i in range(2)]
            errs["gate_p_max_ulps"] = _gate_same(arch, LM_ENGINE, keys, list(out["cpu"][1:]))
            rows[arch] = errs
            self.say(f"{phase} {arch} (smoke) card against CPU: {errs}")
            del card, cpu
        return rows

    def _lm_launcher(self, report):
        argv = ["--arch", LM_ARCH, "--requests", "4", "--new-tokens", "8", "--stochastic-gate"]
        _reset_launches()
        t0 = time.perf_counter()
        reqs = serve_launcher.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in _launches().items() if v}
        if any(len(q.out_tokens) != 8 for q in reqs) or not launches.get("bayes_decide"):
            raise AssertionError(f"launch.serve {argv}: tokens "
                                 f"{[len(q.out_tokens) for q in reqs]}, launches {launches}")
        torch.cuda.empty_cache()
        with _GateRecorder() as cpu_rec:
            cpu = serve_lm.run(device="cpu")
        with _GateRecorder() as card_rec:
            card = serve_lm.run(device="cuda")
        held, total = _hold_lm_runs("serve_lm", card_rec.calls, cpu_rec.calls,
                                    EngineConfig().ensemble_temp)
        if held == total and not np.array_equal(card["tokens"], cpu["tokens"]):
            raise AssertionError("serve_lm: the card's tokens differ from the CPU's")
        report["launcher"] = {"argv": argv, "s": secs, "launches": launches,
                              "tokens": [q.out_tokens for q in reqs]}
        report["serve_lm"] = {"steps_held": held, "steps": total,
                              "tokens_equal": bool(np.array_equal(card["tokens"], cpu["tokens"]))}
        self.say(f"lm_serve launch.serve {' '.join(argv)}: {secs:.1f} s with the init, launches "
                 f"{launches}; serve_lm on the card against the CPU: {held}/{total} steps held "
                 f"(tokens equal: {report['serve_lm']['tokens_equal']})")

    # ---------------------------------------------------- the other block kinds
    def lm_blocks(self):
        """The block kinds of queue 1 item 2 on the card: recurrentgemma-2b and
        xlstm-350m at their published configs served through ServeEngine with
        the stochastic gate; seamless at its published config through api;
        llama4 and deepseek at full width, depth cut (with the sort dispatch
        against the dense impl and deepseek's MTP fusion); card against CPU."""
        report = self.report["lm_blocks"] = {}
        for arch in BLOCKS_SERVED:
            self._blocks_served(report, arch)
        self._blocks_encdec(report)
        for arch in BLOCKS_MOE_CUTS:
            self._blocks_moe(report, arch)
        cut = report["card_vs_cpu"] = {}
        for arch, kw, dtype in BLOCKS_CPU_CUTS:
            cfg = dataclasses.replace(get_config(arch), **kw)
            what = f"{arch} x{cfg.num_layers} {str(dtype)[6:]}"
            row = cut[what] = self._card_vs_cpu(what, cfg, dtype=dtype)
            self.say(f"lm_blocks {what} at full width, card against CPU: logits max abs diff per "
                     f"step {[round(e, 4) for e in row['max_abs_diff']]}, relative "
                     f"{max(row['relative']):.2e} at most; greedy {row['greedy_agree']}/"
                     f"{row['greedy_of']}; gate equal")
        report["smoke"] = self._smoke_card_vs_cpu("lm_blocks", BLOCKS_SMOKE)

    def _blocks_served(self, report, arch):
        cfg = get_config(arch)
        params, init = _init_on_card(cfg)
        consistency = _consistency(params, cfg)
        row = report[arch] = {"layers": cfg.num_layers, "reduced": None, **init,
                              "consistency_max_abs_diff": consistency,
                              **self._serve(cfg, params)}
        self.say(f"lm_blocks {arch} (full config, {cfg.num_layers} layers, {init['params']:,} "
                 f"params, {init['param_bytes'] / 1e9:.2f} GB): init {init['init_s']:.1f} s, peak "
                 f"{init['init_peak_bytes'] / 1e9:.2f} GB; prefill vs forward max diff "
                 f"{consistency['prefill']:.4f}, decode {consistency['decode']:.4f}")
        self._say_served(f"lm_blocks {arch}", row)
        del params
        _free_card()

    def _blocks_encdec(self, report):
        """seamless: a prefill of frames and tokens, then greedy decode steps."""
        cfg = get_config(BLOCKS_ENCDEC)
        params, init = _init_on_card(cfg)
        consistency = _consistency(params, cfg)
        toks, frames = _lm_batch(cfg, "cuda")
        ms = []
        with torch.inference_mode():
            def timed(fn, *args):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args)
                e1.record()
                ms.append((e0, e1))
                return out
            lg, st = timed(api.prefill, params, cfg, _batch_of(toks, frames), 32)
            for t in range(BLOCKS_DECODE_STEPS):
                lg, st = timed(api.decode, params, cfg, torch.argmax(lg, -1), st, toks.shape[1] + t)
                if tuple(lg.shape) != (toks.shape[0], layers.pad_vocab(cfg.vocab_size)) or \
                        not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"seamless decode step {t}: logits {tuple(lg.shape)}")
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in ms]
        dec = sorted(ms[1:])
        row = report[BLOCKS_ENCDEC] = {
            "layers": [cfg.enc_layers, cfg.dec_layers], "reduced": None, **init,
            "serve_peak_bytes": torch.cuda.max_memory_allocated(),
            "consistency_max_abs_diff": consistency, "frames": list(frames.shape),
            "prefill_ms": ms[0], "decode_ms_median": dec[len(dec) // 2], "decode_ms_min": dec[0],
            "decode_ms_max": dec[-1]}
        self.say(f"lm_blocks {BLOCKS_ENCDEC} (full config, {cfg.enc_layers} + {cfg.dec_layers} "
                 f"layers, {init['params']:,} params): init {init['init_s']:.1f} s, peak "
                 f"{init['init_peak_bytes'] / 1e9:.2f} GB; prefill vs forward {consistency}; "
                 f"prefill of {tuple(frames.shape[:2])} frames + {toks.shape[1]} tokens "
                 f"{ms[0]:.2f} ms, decode per step median {row['decode_ms_median']:.2f} ms "
                 f"(min {dec[0]:.2f}, max {dec[-1]:.2f}) over {len(dec)} steps")
        del params, st
        _free_card()

    def _blocks_moe(self, report, arch):
        """An MoE arch at full width, depth cut: init, decode after prefill against
        the teacher-forced forward (routing compared first), the sort dispatch
        against the dense impl on its first MoE layer, deepseek's MTP fusion."""
        cut = BLOCKS_MOE_CUTS[arch]
        cfg = dataclasses.replace(get_config(arch), **cut)
        params, init = _init_on_card(cfg)
        with _Routes() as routes:
            consistency = _consistency(params, cfg, routes)
        row = report[arch] = {"layers": cfg.num_layers, **init,
                              "reduced": {k: f"{v} (from {getattr(get_config(arch), k)}): the "
                                          f"whole config does not fit one 80 GB card"
                                          for k, v in cut.items()},
                              "consistency_max_abs_diff": consistency}
        row["dispatch"] = self._moe_dispatch(cfg, params["blocks"][0][0]["moe"])
        if cfg.mtp_heads:
            row["mtp_fusion"] = self._mtp_fusion(cfg, params)
        self.say(f"lm_blocks {arch} (full width, {cfg.num_layers} layers, {init['params']:,} "
                 f"params, {init['param_bytes'] / 1e9:.2f} GB): init {init['init_s']:.1f} s, peak "
                 f"{init['init_peak_bytes'] / 1e9:.2f} GB; prefill vs forward {consistency}; sort "
                 f"dispatch vs dense {row['dispatch']}" + (
                     f"; MTP fusion {row['mtp_fusion']}" if cfg.mtp_heads else ""))
        del params
        _free_card()

    def _moe_dispatch(self, cfg, layer):
        """The sort dispatch at a capacity no expert can overflow against the
        dense all-experts impl, on one layer's own weights (2 x 12 tokens)."""
        e = cfg.moe
        nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
            e, capacity_factor=float(e.num_experts)))         # cap = k T
        dense = dataclasses.replace(nodrop, moe=dataclasses.replace(nodrop.moe, impl="dense"))
        gen = torch.Generator(device="cuda").manual_seed(6)
        x = torch.randn((2, 12, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        ms = {}
        with torch.inference_mode(), _Routes() as routes:
            outs = []
            for name, c in (("sort", nodrop), ("dense", dense)):
                outs.append(moe.moe_apply(layer, x, c)[0])
                ms[name] = _event_ms(lambda c=c: moe.moe_apply(layer, x, c), 5)
        if not torch.equal(routes.calls[0][1], routes.calls[1][1]):
            raise AssertionError(f"{cfg.name}: the two impls route differently")
        err = _close(f"{cfg.name} sort dispatch vs dense", outs[0], outs[1], MOE_DISPATCH_TOL)
        return {"max_abs_diff": err, "sort_ms": ms["sort"], "dense_ms": ms["dense"]}

    def _mtp_fusion(self, cfg, params):
        """tests/serve/test_mtp_fusion.py at full width: the main head's and the
        MTP head's posteriors of the same token fused through the stochastic
        gate, one bayes_decide launch (counts reset just before, read just
        after), held equal to its plain version."""
        toks, _ = _lm_batch(cfg, "cuda")
        with torch.inference_mode():
            h, _ = transformer.forward(params, cfg, toks, return_hidden=True)
            main = (h[:, -2] @ params["unembed"]).float()
            h2 = transformer.mtp_hidden(params, cfg, h[:, -3:-2], toks[:, -2:-1])
            mtp = (h2[:, 0] @ params["unembed"]).float()
        sources = torch.stack([main, mtp])
        key = prng.PRNGKey(5)
        torch.cuda.synchronize()
        _reset_launches()
        token, conf = bayes_head.fuse_posteriors_stochastic(key, sources, top_k=8, n_bits=MTP_BITS,
                                                            device="cuda")
        torch.cuda.synchronize()
        launches = {k: v for k, v in _launches().items() if v}
        if launches != {"bayes_decide": 1}:
            raise AssertionError(f"MTP fusion launches {launches}")
        cand, p = bayes_head._candidates(sources, 8, "cuda")
        best, counts = bayes_decide(key, p, MTP_BITS, device="cuda")
        pbest, pcounts = bayes_decide(key, p.cpu(), MTP_BITS, device="cpu")
        if not (torch.equal(best.cpu(), pbest) and torch.equal(counts.cpu(), pcounts)):
            raise AssertionError("MTP fusion: bayes_decide differs from its plain version")
        if not torch.equal(torch.gather(cand, -1, best[:, None].long())[:, 0], token):
            raise AssertionError("MTP fusion: the token is not the kernel's decision")
        row = self._decide_timing(key, p, MTP_BITS)
        row.update(launches=1, tokens=token.tolist(), confidence=conf.tolist(),
                   main_vs_mtp_top1_equal=(torch.argmax(main, -1) == torch.argmax(mtp, -1)).tolist())
        self.mtp_gate = row
        return row

    # -------------------------------------------------------- the training path
    def lm_train(self):
        """The training stack on the card: phi3-mini-3.8b at its published
        config trained through TrainLoop, its params and master restored in
        place into the live state; at its full width cut to 2 layers,
        one make_train_step card against CPU, microbatches 2 against 1, and
        the checkpoint cycle; the ten archs' smoke configs, launch.train and
        examples.train_lm card against CPU."""
        report = self.report["lm_train"] = {}
        _free_card()
        self._train_full(report)
        _free_card()
        self._train_cut(report)
        _free_card()
        self._train_resume(report)
        _free_card()
        self._train_smoke(report)
        self._train_launchers(report)

    def multi_device(self):
        """The multi-device half: the sharded sweep, the sharded_sweep
        example, MoE expert parallelism at llama4-scout's width, the sharded
        loss at phi3's width cut to 2 layers, the GPipe pipeline and
        compressed_mean, on worlds of ranks (``_md_worlds``).  Two ranks on
        one card measure the logic and the host copies of gloo, not NVLink."""
        _free_card()
        report = self.report["multi_device"] = {"worlds": {}}
        by_step = {}                   # step -> each rank's report of it
        for tag, n, backend_name, steps in _md_worlds(torch.cuda.device_count()):
            t0 = time.perf_counter()
            got = _md_world(n, backend_name, steps)
            report["worlds"][tag] = {"ranks": n, "backend": backend_name, "steps": steps,
                                     "seconds": time.perf_counter() - t0, "per_rank": got}
            by_step.update({k: [r[k] for r in got] for k in steps})
            self.say(f"multi_device: {', '.join(steps)} on {n} ranks over {backend_name}")
        if "gloo" in report["worlds"]:
            self.say("multi_device: the sharded loss at 1 rank over NCCL: gloo's functional "
                     "all_gather on CUDA tensors (DTensor's Shard -> Replicate) kills the "
                     "process, and gloo refuses send/recv of CUDA tensors")
        sw = by_step["sweep"]
        n = len(sw)
        self.md_launches = [r["launches_per_rank"] for r in sw]
        if min(self.md_launches) < 2 * len(NAMES):
            raise AssertionError(f"net_sweep launches per rank {self.md_launches}, "
                                 f"want {2 * len(NAMES)}")
        self.say(f"multi_device sweep: 7 scenarios x run+decide at B={BATCH}, n_bits={N_BITS} "
                 f"on {n} ranks, bit-equal to the single launch; net_sweep launches per rank "
                 f"{self.md_launches}, odd batch {[r['odd_launches_per_rank'] for r in sw]}; "
                 f"{TIMED_SCENARIO} {[round(r['sharded_fps']) for r in sw]} frames/s sharded "
                 f"against {[round(r['single_fps']) for r in sw]} single; {sw[0]['seconds']:.1f} s")
        ex = by_step["example"][0]
        self.say(f"multi_device sharded_sweep.run: {ex['frames']} frames on {ex['n_shards']} "
                 f"shards, single {ex['single_fps']:,.0f} / sharded {ex['sharded_fps']:,.0f} "
                 f"frames/s, drain {ex['drained']} frames in {ex['drain_s'] * 1e3:.1f} ms")
        mo = by_step["moe"]
        self.say(f"multi_device moe {mo[0]['arch']}: {mo[0]['experts']} experts, leaves "
                 f"{mo[0]['expert_leaves_gb']:.2f} GB, tokens {mo[0]['tokens']}: EP against "
                 f"local max abs err {max(r['max_abs_err'] for r in mo):.3g} (atol, rtol "
                 f"{mo[0]['tol']}); EP {mo[0]['ep_ms']:.1f} ms, local {mo[0]['local_ms']:.1f} ms")
        lo = by_step["loss"]
        self.say(f"multi_device loss {lo[0]['arch']} cut to {lo[0]['layers']} layers "
                 f"({lo[0]['params']:,} params), tokens {lo[0]['tokens']}, {len(lo)} ranks: "
                 f"sharded {[r['sharded'] for r in lo]} against {lo[0]['plain']:.6f} (rel "
                 f"{max(r['rel_err'] for r in lo):.2e}, rtol {lo[0]['rtol']}); "
                 f"{lo[0]['sharded_s']:.2f} s")
        pi = by_step["pipeline"]
        self.say(f"multi_device pipeline d={pi[0]['d']}, {pi[0]['stages']} stages, "
                 f"{pi[0]['microbatches']} microbatches: max abs err "
                 f"{max(r['max_abs_err'] for r in pi):.3g} (tol {pi[0]['tol']}), "
                 f"{pi[0]['pipeline_s']:.3f} s; compressed_mean "
                 f"{by_step['compressed_mean'][0]['shape']} over data bit-equal on every rank")
        report["seconds_by_step"] = {k: max(r["seconds"] for r in v) for k, v in by_step.items()}
        report["peak_gb_per_rank"] = {k: max(r["peak_gb"] for r in v) for k, v in by_step.items()}
        self.say(f"multi_device seconds by step {report['seconds_by_step']}; peak GB per rank "
                 f"{report['peak_gb_per_rank']}")

    def dryrun(self):
        """The H100-cluster dry run (``repro_torch.launch.dryrun``): (a) the
        production cells of DRYRUN_CELLS, each a ``python -m
        repro_torch.launch.dryrun`` process on a fake world of 256 ranks,
        all started together (those of DRYRUN_EARLY when the script
        started); one sLSTM layer's trace (SLSTM_TRACE); (b) and (c) in a
        process of their own (``_dryrun_on_card``).  Each process runs
        under a timeout."""
        report = self.report["dryrun"] = {"cells": {}}
        out = ROOT / "chiprun_out" / "dryrun"
        out.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        runs = {k: cmd for k, cmd in _dryrun_cells(out).items() if k not in self.early}
        runs["card"] = [sys.executable, "-c", "import sys, chip_smoke; "
                        "chip_smoke._dryrun_on_card(sys.argv[1])", str(out / "card.json")]
        runs["slstm"] = slstm_trace_cmd(ROOT, [SLSTM_TRACE_SEQ])
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for k, cmd in runs.items()}
        try:
            logs = {k: p.communicate(timeout=DRYRUN_TIMEOUT)[0] for k, p in procs.items()}
            for k, (proc, log, deadline) in self.early.items():
                proc.wait(timeout=max(deadline - time.monotonic(), 0))
                procs[k], logs[k] = proc, log.read_text()
        finally:
            for p in procs.values():
                p.kill()
            self.stop()
        report["seconds"] = time.perf_counter() - t0
        failed = [k for k, p in procs.items() if p.returncode != 0]
        for k in failed:
            print(f"dryrun {k} exited {procs[k].returncode}:\n{logs[k][-3000:]}", flush=True)
        for arch, shape, mesh in DRYRUN_CELLS:
            for multi in {"single": [False], "multi": [True], "both": [False, True]}[mesh]:
                name = dryrun_mod._mesh_name(multi)
                path = out / f"{arch}__{shape}__{name}.json"
                cell = json.loads(path.read_text()) if path.exists() else {"ok": False}
                report["cells"][f"{arch}__{shape}__{name}"] = cell
                if not cell.get("ok"):
                    failed.append(f"{arch} {shape} {name}: {cell.get('error', 'no result')}")
                    continue
                self.say(f"dryrun {arch} {shape} on {name} ({cell['chips']} GPUs): compute "
                         f"{cell['compute_s']:.4g} s, memory {cell['memory_s']:.4g} s, collective "
                         f"{cell['collective_s']:.4g} s (NVLink {cell['collective_by_link']['nvlink']:.4g}"
                         f" B, IB {cell['collective_by_link']['ib']:.4g} B); {cell['bottleneck']}-bound, "
                         f"useful {cell['useful_ratio']:.3f}; peak {cell['memory']['peak_gb']:.2f} GB "
                         f"per GPU; trace {cell['trace_seconds']} s, calibrated {cell['calibrated']}")
        for tag in DRYRUN_FIT:
            fit = report["cells"].get(tag, {})
            if fit.get("ok") and fit["memory"]["peak_gb"] > DRYRUN_FIT_GB:
                failed.append(f"{tag} peaks at {fit['memory']['peak_gb']:.1f} GB per GPU, above "
                              f"{DRYRUN_FIT_GB}")
        if "slstm" not in failed:
            report["slstm_trace_s"] = json.loads(logs["slstm"].strip().splitlines()[-1])
            self.say(f"dryrun one sLSTM layer of xlstm-350m traced at 8 x {SLSTM_TRACE_SEQ} per GPU "
                     f"on the h100x32x8 fake world: {report['slstm_trace_s']} s")
        if failed:
            raise AssertionError(f"dryrun: failed {failed}")
        card = report["card"] = json.loads((out / "card.json").read_text())
        fake, real = card["fake"], card["real"]
        share = abs(fake["peak_bytes"] - card["max_memory_allocated"]) / card["max_memory_allocated"]
        card["peak_share"] = share
        self.say(f"dryrun fake against real, {DRYRUN_ARCH} x{card['layers']} layers at "
                 f"{card['shape']}: FLOPs {real['flops']:.6g} real, {fake['flops']:.6g} fake; "
                 f"bytes {real['bytes']:.6g} real, {fake['bytes']:.6g} fake; peak "
                 f"{fake['peak_bytes'] / 1e9:.3f} GB fake, {card['max_memory_allocated'] / 1e9:.3f}"
                 f" GB max_memory_allocated ({share:.1%} apart); step {card['step_ms']:.1f} ms "
                 f"against compute {card['compute_s'] * 1e3:.2f} ms, memory "
                 f"{card['memory_s'] * 1e3:.2f} ms")
        w = card["whole"]
        self.say(f"dryrun whole {DRYRUN_ARCH} at {card['shape']}, one GPU: forward+backward "
                 f"{w['fwd_bwd']['bytes'] / 1e12:.3f} TB, memory term "
                 f"{w['fwd_bwd']['memory_ms']:.1f} ms, compute {w['fwd_bwd']['compute_ms']:.1f} ms "
                 f"(measured 343-427 ms, PERF.md 5); optimizer {w['optimizer']['bytes'] / 1e12:.3f}"
                 f" TB, memory term {w['optimizer']['memory_ms']:.1f} ms (measured 379-381 ms); "
                 f"peak {w['step']['peak_bytes'] / 1e9:.2f} GB; {w['seconds']:.1f} s of tracing")
        if (real["flops"], real["bytes"]) != (fake["flops"], fake["bytes"]):
            raise AssertionError(f"dryrun: the fake count {fake} differs from the real {real}")
        if share > DRYRUN_PEAK_SHARE:
            raise AssertionError(f"dryrun: the fake peak is {share:.1%} from the card's")

    def _train_full(self, report):
        args, cfg, data_cfg, train_cfg, opt_cfg = train_launcher.setup(
            ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--global-batch", str(TRAIN_BATCH),
             "--seq-len", str(TRAIN_SEQ)])
        with tempfile.TemporaryDirectory(prefix="lm_train_") as ckpt_dir:
            # ckpt_every beyond the steps: the launcher's steps // 4 would write the
            # whole state (61 GB) at every step
            train_cfg = dataclasses.replace(train_cfg, ckpt_every=TRAIN_STEPS + 1,
                                            ckpt_dir=ckpt_dir)
            loop = TrainLoop(cfg, data_cfg, train_cfg, opt_cfg, device="cuda")
            t0 = time.perf_counter()
            params, opt = loop.init_state(prng.PRNGKey(0))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            n_params = api.param_count(params)
            state_bytes = sum(t.numel() * t.element_size() for t in params.parameters()) + sum(
                t.numel() * 4 for f in ("master", "m", "v") for t in getattr(opt, f).values())
            with _StepTimer() as timer:
                t1 = time.perf_counter()
                params, opt, history = loop.run(prng.PRNGKey(0), params=params, opt_state=opt)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t1
            committed = loop.ckpt.available_steps()
            peak = torch.cuda.max_memory_allocated()
            restored = report["restore"] = self._train_restore_full(
                cfg, opt_cfg, data_cfg, params, opt, ckpt_dir)
        steps = timer.split()
        norms = [float(g) for g in timer.norms]
        losses = [h["loss"] for h in history]
        if len(history) != TRAIN_STEPS or len(steps) != TRAIN_STEPS or committed:
            raise AssertionError(f"{TRAIN_ARCH}: {len(history)} steps, {len(steps)} timed, "
                                 f"checkpoints {committed}")
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            raise AssertionError(f"{TRAIN_ARCH}: losses {losses}, grad norms {norms}")
        timed = steps[TRAIN_TIMED]
        fb = _median([s["fwd_bwd_ms"] for s in timed])
        op = _median([s["opt_ms"] for s in timed])
        step_ms = _median([s["fwd_bwd_ms"] + s["opt_ms"] for s in timed])
        period = _median([s["period_ms"] for s in timed if s["period_ms"] is not None])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = 6 * n_params * tokens
        row = report[TRAIN_ARCH] = {
            "layers": cfg.num_layers, "reduced": None, "params": n_params,
            "state_bytes": state_bytes, "init_s": init_s, "init_peak_bytes": init_peak,
            "peak_bytes": peak, "run_s": run_s, "losses": losses, "grad_norms": norms,
            "lr": opt_cfg.lr, "warmup_steps": opt_cfg.warmup_steps, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "steps": steps, "fwd_bwd_ms": fb, "opt_ms": op, "step_ms": step_ms,
            "period_ms": period, "tokens_per_s": tokens / (step_ms / 1e3),
            "tokens_per_s_period": tokens / (period / 1e3),
            "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3 * BF16_PEAK_FLOPS),
            "mfu_note": "6 N tokens over the step's device time at 989 TFLOP/s dense bf16; "
                        "the recomputed forward is not counted"}
        self.say(f"lm_train {TRAIN_ARCH} (full config, {cfg.num_layers} layers, {n_params:,} "
                 f"params, state {state_bytes / 1e9:.2f} GB): init {init_s:.1f} s (peak "
                 f"{init_peak / 1e9:.2f} GB), peak over {TRAIN_STEPS} steps {peak / 1e9:.2f} GB; "
                 f"losses {[round(x, 4) for x in losses]}, grad norms "
                 f"{[round(x, 4) for x in norms]}; steps 2-5 median: forward+backward "
                 f"{fb:.1f} ms, optimizer {op:.1f} ms, step {step_ms:.1f} ms (period with the "
                 f"host {period:.1f} ms); {row['tokens_per_s']:.0f} tokens/s, model FLOPs "
                 f"utilization {100 * row['mfu']:.1f} % (6 N T, recompute not counted)")
        self.say(f"lm_train {TRAIN_ARCH} in-place restore at full size, params and master: "
                 f"checkpoint {restored['checkpoint_bytes'] / 1e9:.2f} GB (save stall "
                 f"{restored['stall_s']:.1f} s, write {restored['write_s']:.1f} s), restored into the "
                 f"live state in {restored['restore_s']:.1f} s adding "
                 f"{restored['restore_added_bytes'] / 1e9:.3f} GB to the card (one float32 leaf: "
                 f"{restored['restore_leaf_bytes'] / 1e9:.3f} GB); step {TRAIN_STEPS} replayed, loss "
                 f"{restored['losses']}, peak {restored['peak_bytes'] / 1e9:.2f} GB; free disk "
                 f"{restored['disk_free_bytes'] / 1e9:.0f} GB, memory "
                 f"{restored['mem_available_bytes'] / 1e9:.0f} GB before")
        del params, opt, loop

    def _train_restore_full(self, cfg, opt_cfg, data_cfg, params, opt, ckpt_dir):
        """The in-place restore at full size, into the live state: the params
        and the float32 master after TRAIN_STEPS steps saved (half of the
        whole state's 61 GB checkpoint, which would pass the machine's disk
        allowance), one more step taken, the two restored into the state
        that step left and the step replayed from them."""
        need = 8 * api.param_count(params)
        room = _disk_and_memory(ckpt_dir)
        if room["disk_free_bytes"] < TRAIN_RESTORE_ROOM * need or \
                room["mem_available_bytes"] < TRAIN_RESTORE_ROOM * need:
            raise AssertionError(f"the full-size restore needs {TRAIN_RESTORE_ROOM} x "
                                 f"{need / 1e9:.1f} GB of disk and of host memory: {room}")
        what = f"{TRAIN_ARCH} restore"
        saved = _bit_sums((params, opt.master))
        marks = {}
        ckpt = Checkpointer(ckpt_dir)
        t0 = time.perf_counter()
        ckpt.save(TRAIN_STEPS, (params, opt.master))
        marks["stall_s"] = time.perf_counter() - t0
        ckpt.wait()
        marks["write_s"] = time.perf_counter() - t0 - marks["stall_s"]
        marks["checkpoint_bytes"] = sum(
            f.stat().st_size for f in (pathlib.Path(ckpt_dir) / f"step_{TRAIN_STEPS}").iterdir())
        step = make_train_step(cfg, opt_cfg)
        batch = batch_at_step(data_cfg, TRAIN_STEPS, device="cuda")
        params, opt, first = step(params, opt, batch)
        if torch.equal(_bit_sums((params, opt.master)), saved):
            raise AssertionError(f"{what}: the step changed no bit sum")
        _timed_restore(ckpt, marks)
        ckpt.restore((params, opt.master))
        if not torch.equal(_bit_sums((params, opt.master)), saved):
            raise AssertionError(f"{what}: the restored bit sums differ from the saved ones")
        torch.cuda.reset_peak_memory_stats()
        params, opt, replay = step(params, opt, batch)
        losses = [first["loss"].item(), replay["loss"].item()]
        if losses[0] != losses[1] or not np.isfinite(losses[0]):
            raise AssertionError(f"{what}: the replayed step's loss {losses[1]} against {losses[0]}")
        _hold_restore_memory(what, marks)
        return {**marks, **room, "restored": "params and master", "restored_equal": True,
                "peak_bytes": torch.cuda.max_memory_allocated(), "losses": losses}

    def _train_cut(self, report):
        """phi3 at full width cut to 2 layers: one make_train_step on the card
        against the CPU (weights copied from the card), then 2 microbatches
        against 1 on the card."""
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_CUT)
        _, _, _, _, opt_cfg = train_launcher.setup(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS)])
        data = train_launcher.data_config(cfg, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ)
        init = copy.deepcopy(api.init(cfg, prng.PRNGKey(0), device="cuda")).to("cpu")
        step = make_train_step(cfg, opt_cfg)
        out, secs = {}, {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(init).to(dev)
            t0 = time.perf_counter()
            out[dev] = step(model, adamw.init(model), batch_at_step(data, 0, device=dev))
            out[dev][2]["loss"].item()                 # waits for the device
            secs[dev] = time.perf_counter() - t0
        what = f"{TRAIN_ARCH} x{cfg.num_layers}"
        row = report["card_vs_cpu"] = {"layers": cfg.num_layers, "batch": [TRAIN_CUT_BATCH,
                                                                        TRAIN_CUT_SEQ],
                                       "cpu_s": secs["cpu"], "card_s": secs["cuda"],
                                       **_hold_step(what, out["cuda"], out["cpu"], opt_cfg.lr)}
        del out
        mb = {}
        for n in (1, 2):
            model = copy.deepcopy(init).to("cuda")
            mb[n] = make_train_step(cfg, opt_cfg, microbatches=n)(
                model, adamw.init(model), batch_at_step(data, 0, device="cuda"))
        (p1, _, m1), (p2, _, m2) = mb[1], mb[2]
        if abs(m1["loss"].item() - m2["loss"].item()) > 1e-3 * abs(m1["loss"].item()):
            raise AssertionError(f"microbatches: loss {m2['loss'].item()} against {m1['loss'].item()}")
        if {p.dtype for p in p2.parameters()} != {torch.float32}:
            raise AssertionError("microbatches: the params did not take the float32 gradients' dtype")
        mb_diff = max(float((a.detach().float() - b.detach().float()).abs().max())
                      for a, b in zip(p1.parameters(), p2.parameters()))
        if mb_diff > 2e-2:
            raise AssertionError(f"microbatches: params differ by {mb_diff}")
        row["microbatches"] = {"loss_1": m1["loss"].item(), "loss_2": m2["loss"].item(),
                               "max_param_diff": mb_diff, "dtypes_2": ["float32"]}
        self.say(f"lm_train {what} at full width, card against CPU: {row}")
        del mb, p1, p2, init

    def _train_resume(self, report):
        """The checkpoint cycle at the 2-layer cut, under
        torch.use_deterministic_algorithms: a loop stopped at step 2 and
        resumed to 4 ends bit for bit where an uninterrupted loop ends."""
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_CUT)
        _, _, _, _, opt_cfg = train_launcher.setup(
            ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_RESUME_STEPS)])
        data = train_launcher.data_config(cfg, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ)
        base = pathlib.Path(tempfile.mkdtemp(prefix="lm_train_ckpt_"))
        room = _disk_and_memory(base)
        if room["disk_free_bytes"] < TRAIN_MIN_FREE_BYTES:
            shutil.rmtree(base)
            raise AssertionError(f"the checkpoint cycle needs {TRAIN_MIN_FREE_BYTES / 1e9:.0f} GB "
                                 f"free under {base}: {room}")
        marks = {}
        torch.use_deterministic_algorithms(True)
        try:
            def loop(steps, every, sub):
                return TrainLoop(cfg, data, TrainConfig(steps=steps, ckpt_every=every,
                                                        ckpt_dir=str(base / sub)),
                                 opt_cfg, device="cuda")
            whole = loop(TRAIN_RESUME_STEPS, TRAIN_RESUME_STEPS + 1, "whole")
            p_whole, o_whole, h_whole = whole.run(prng.PRNGKey(0))
            want = _state_of(p_whole, o_whole)
            del p_whole, o_whole
            _free_card()

            first = loop(2, 2, "cycle")
            save = first.ckpt.save

            def timed_save(step, tree, **kw):
                t0 = time.perf_counter()
                save(step, tree, **kw)
                marks["saved"] = time.perf_counter()
                marks["stall_s"] = marks["saved"] - t0
            first.ckpt.save = timed_save
            _, _, h_first = first.run(prng.PRNGKey(0))
            marks["write_s"] = time.perf_counter() - marks["saved"]
            disk = sum(f.stat().st_size for f in (base / "cycle" / "step_2").iterdir())
            del first
            _free_card()

            second = loop(TRAIN_RESUME_STEPS, TRAIN_RESUME_STEPS + 1, "cycle")
            _timed_restore(second.ckpt, marks)
            p_res, o_res, h_second = second.run(prng.PRNGKey(0))
            got = _state_of(p_res, o_res)
            step_res = int(o_res.step)
            del p_res, o_res, second
        finally:
            torch.use_deterministic_algorithms(False)
            shutil.rmtree(base, ignore_errors=True)
        if [h["step"] for h in h_first + h_second] != list(range(TRAIN_RESUME_STEPS)) or \
                step_res != TRAIN_RESUME_STEPS:
            raise AssertionError(f"resume: steps {[h['step'] for h in h_first + h_second]}, "
                                 f"optimizer step {step_res}")
        if [h["loss"] for h in h_first + h_second] != [h["loss"] for h in h_whole]:
            raise AssertionError(f"resume: losses {[h['loss'] for h in h_first + h_second]} "
                                 f"against {[h['loss'] for h in h_whole]}")
        differ = [n for n in want[0] if not torch.equal(want[0][n], got[0][n])]
        differ += [f"{f}.{k}" for f in want[1] for k in want[1][f]
                   if not torch.equal(want[1][f][k], got[1][f][k])]
        if differ:
            raise AssertionError(f"resume: {len(differ)} leaves differ from the uninterrupted "
                                 f"loop, first {differ[:4]}")
        _hold_restore_memory("resume", marks)
        row = report["resume"] = {"layers": cfg.num_layers, "deterministic": True,
                                  "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                                  "checkpoint_bytes": disk, **room, **marks,
                                  "losses": [h["loss"] for h in h_whole]}
        self.say(f"lm_train {TRAIN_ARCH} x{cfg.num_layers}: stopped at step 2 and resumed to "
                 f"{TRAIN_RESUME_STEPS} equals the uninterrupted loop bit for bit (deterministic "
                 f"algorithms); checkpoint {disk / 1e9:.2f} GB, save stall "
                 f"{marks['stall_s']:.2f} s, async write {marks['write_s']:.2f} s, restore "
                 f"{marks['restore_s']:.2f} s in place (adding "
                 f"{marks['restore_added_bytes'] / 1e9:.3f} GB to the card); free disk {room['disk_free_bytes'] / 1e9:.0f} GB, "
                 f"memory {room['mem_available_bytes'] / 1e9:.0f} GB")
        del want, got

    def _train_smoke(self, report):
        """The ten archs' smoke configs: one make_train_step on the card
        against the CPU from the same weights, MoE routing compared first."""
        rows = report["smoke"] = {}
        for arch in (a for a in ARCH_IDS if a != "paper-bayes-fusion"):
            cfg = get_smoke_config(arch)
            _, _, _, _, opt_cfg = train_launcher.setup(["--arch", arch, "--smoke", "--steps", "10"])
            data = train_launcher.data_config(cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ)
            init = copy.deepcopy(api.init(cfg, prng.PRNGKey(0), device="cuda")).to("cpu")
            batch = batch_at_step(data, 0, device="cpu")

            def step(rows):
                """The step on both devices from ``init`` on the batch's
                ``rows``: (results, routing agreement or None)."""
                out, routes = {}, {}
                for dev in ("cpu", "cuda"):
                    model = copy.deepcopy(init).to(dev)
                    b = {k: v[rows].to(dev) for k, v in batch.items()}
                    with torch.no_grad(), _Routes() as r:
                        api.loss(model, cfg, b)
                    routes[dev] = r.calls
                    out[dev] = make_train_step(cfg, opt_cfg)(model, adamw.init(model), b)
                if not cfg.moe:
                    return out, None, None
                return out, *_route_agreement(cfg, len(rows), [
                    (a[0], a[1], b[1]) for a, b in zip(routes["cpu"], routes["cuda"])])

            row = {}
            out, held, routing = step(torch.arange(TRAIN_SMOKE_BATCH))
            alike = not cfg.moe or routing["differ"] == 0
            if cfg.moe:
                row["routing"] = routing
            if not alike:
                # a near-tie flipped: the step again on the rows that route alike
                out, _, row["routing_held_rows"] = step(held)
                alike = row["routing_held_rows"]["differ"] == 0
            row.update(_hold_step(f"{arch} (smoke)", out["cuda"], out["cpu"], opt_cfg.lr,
                                  routed_alike=alike))
            rows[arch] = row
            self.say(f"lm_train {arch} (smoke) train step, card against CPU: {row}")
            del out, init

    def _train_launchers(self, report):
        """launch.train --smoke and examples.train_lm on the card against the
        CPU (every step's loss within TRAIN_TRAJ_ATOL); then the example on the
        card at its script's 60 steps, whose loss must decrease."""
        hist, secs = {}, {}
        with tempfile.TemporaryDirectory(prefix="lm_train_launch_") as d:
            for dev in ("cpu", "cuda"):
                argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(TRAIN_LAUNCH_STEPS),
                        "--device", dev, "--ckpt-dir", str(pathlib.Path(d) / dev)]
                t0 = time.perf_counter()
                hist[dev] = [h["loss"] for h in train_launcher.main(argv)]
                secs[dev] = time.perf_counter() - t0
        launch_diff = max(abs(a - b) for a, b in zip(hist["cuda"], hist["cpu"]))
        if len(hist["cuda"]) != TRAIN_LAUNCH_STEPS or launch_diff > TRAIN_TRAJ_ATOL:
            raise AssertionError(f"launch.train: card {hist['cuda']} against CPU {hist['cpu']}")
        ex = {dev: train_lm.run(dev, steps=TRAIN_EXAMPLE_STEPS) for dev in ("cpu", "cuda")}
        ex_diff = max(abs(a - b) for a, b in zip(ex["cuda"]["losses"], ex["cpu"]["losses"]))
        if ex_diff > TRAIN_TRAJ_ATOL:
            raise AssertionError(f"train_lm: card {ex['cuda']['losses']} against CPU "
                                 f"{ex['cpu']['losses']}")
        t0 = time.perf_counter()
        full = train_lm.run("cuda")
        full_s = time.perf_counter() - t0
        if not full["losses"][-1] < full["losses"][0]:
            raise AssertionError(f"train_lm: the loss did not decrease: {full['losses']}")
        report["launch_train"] = {"steps": TRAIN_LAUNCH_STEPS, "losses_card": hist["cuda"],
                                  "losses_cpu": hist["cpu"], "max_abs_diff": launch_diff,
                                  "card_s": secs["cuda"], "cpu_s": secs["cpu"]}
        report["train_lm"] = {"steps_compared": TRAIN_EXAMPLE_STEPS, "max_abs_diff": ex_diff,
                              "losses_card": ex["cuda"]["losses"], "losses_cpu": ex["cpu"]["losses"],
                              "full_steps": full["steps"], "full_losses": full["losses"],
                              "full_s": full_s, "params": full["n_params"],
                              "checkpoints": full["checkpoints"]}
        self.say(f"lm_train launch.train --smoke x{TRAIN_LAUNCH_STEPS} card against CPU: losses "
                 f"within {launch_diff:.4f} ({secs['cuda']:.1f} s on the card, "
                 f"{secs['cpu']:.1f} s on the CPU); train_lm x{TRAIN_EXAMPLE_STEPS} within "
                 f"{ex_diff:.4f}; train_lm on the card ({full['n_params'] / 1e6:.1f}M params, "
                 f"{full['steps']} steps, {full_s:.1f} s): loss {full['losses'][0]:.3f} -> "
                 f"{full['losses'][-1]:.3f}, checkpoints at {full['checkpoints']}")


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
        # (M, rows off the block grid, K, n_bits, counter origin); then one row
        # and the unfused root's 1024 rows of 4096 bits, bench_latency's
        # decision, a bayes_head batch (64 tokens, top 8 classes), and K = 33
        cases = [(1, 4099, 2, 128, 0), (2, 4099, 16, 128, 0), (3, 1000, 16, 64, 0),
                 (2, 257, 2, 256, 2**32 - 1000), (3, 333, 16, 96, 2**32 - 5000),
                 (1, 1, 1, N_BITS, 2**32 - 100), (1, BATCH, 1, N_BITS, 0),
                 (2, LAT_DECISIONS, 2, LAT_BITS, 0), (2, HEAD_TOKENS, HEAD_CLASSES, HEAD_BITS, 0),
                 (3, 100, 33, 128, 2**32 - 3000)]
        for m, r, k, n_bits, offset in cases:
            p = torch.rand((m, r, k), generator=gen, device="cuda")
            if r > 1:
                p[:, 1] = 0.0                         # every class ties at count 0
            n = min(p.numel(), edge.numel())
            p.view(-1)[:n] = edge[:n]                 # clipped values and DAC half steps
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
        # fusion_map at every shape of FM_ROUTE x FM_MODS x FM_ROWS, with a
        # non-uniform prior and with none (the kernel's own uniform prior)
        routes = {}
        for k in FM_ROUTE:
            prior = torch.rand(k, generator=gen, device="cuda") + 0.1
            prior /= prior.sum()
            uniform = torch.full((k,), 1.0 / k, device="cuda")
            for m in FM_MODS:
                for r in FM_ROWS:
                    p = torch.rand((m, r, k), generator=gen, device="cuda")
                    n = min(p.numel(), edge.numel())
                    p.view(-1)[:n] = edge[:n]
                    for given, plain in ((prior, prior), (None, uniform)):
                        fused = fm_kernel.fusion_map_cuda(p, given)
                        self._note("fusion_map", _float_err(fused, fusion_map_ref(p, plain)))
                    routes[k] = fm_kernel.route(p, fused)
        if routes != FM_ROUTE:
            raise AssertionError(f"fusion_map took routes {routes}, not {FM_ROUTE}")
        self.report["fusion_map_routes"] = routes
        print(f"operators: fusion_map at K {sorted(FM_ROUTE)} x M {list(FM_MODS)} x R "
              f"{list(FM_ROWS)}, a prior and none, on its routes {routes}: within atol "
              f"{FM_ATOL}, rtol {FM_RTOL} (max abs err {self.op_err['fusion_map']:.3g})",
              flush=True)
        print(f"operators: {len(cases)} cases (M 1..3, K 1/2/8/16/33, one row, rows off the "
              f"block grid, the unfused root, bench_latency and bayes_head shapes, counter "
              f"origins wrapping 2**32) equal to the plain versions: max abs err "
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
        obstacle_want = obstacle_fusion.run("cpu")
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
        obstacle = obstacle_fusion.run("cuda")
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

    def _int_ms(self, alu, muladd):
        """Least ms for ``alu`` operations only the 64 ALU lanes of an SM run and
        ``muladd`` that may also use the other 64 (net_sweep's yardstick)."""
        clocks = max(alu / INT32_LANES_PER_SM, (alu + muladd) / DISPATCH_LANES_PER_SM)
        return clocks / (self.n_sm * self.max_clock_mhz * 1e6) * 1e3

    def _op_bound(self, name, p, n_bits):
        """(bound ms, what sets it, operations, bytes, share of streams hashed)
        of one launch on p (M, R, K).  The encoders' work is counted for the
        streams these inputs need: a threshold of 0 or 256 gives all-zero or
        all-one words with no hash, and bayes_decide needs no word of an
        (r, k) stream that a modality holds at 0."""
        m, px, k = p.shape
        w, hashed = n_bits // 32, None
        if name in ("sne_encode", "bayes_decide"):
            t = torch.clamp(torch.round(p * 256), 0, 256)
            live = (t > 0) & (t < 256)                  # streams whose words are hashed
            if name == "bayes_decide":
                live &= ~(t == 0).any(0)
            streams = int(live.sum())
            hashed = streams / p.numel()
            words = streams * (n_bits // 4)             # entropy words, one hash each
            alu, muladd = words * SNE_ALU_OPS, words * SNE_MULADD_OPS
            if name == "sne_encode":
                nbytes = 4 * m * px * k * (1 + w)
            else:   # per word of a stream with M' hashed modalities: M' - 1 ANDs and a
                # popcount, and an add; per class: the argmax's compare and select
                alu += w * streams + 2 * px * k
                muladd += w * int(live.any(0).sum())
                nbytes = 4 * (m * px * k + px * k + px)
            del t, live
            ops, op_ms = alu + muladd, self._int_ms(alu, muladd)
        else:
            if name == "pand_popcount":
                rows = px * k
                ops, nbytes = rows * w * (m + 1), 4 * rows * (m * w + 1)   # ANDs, popcount, add
                rate = self.int32_ops_per_s
            else:   # fusion_map: clip, log, add per input; sub, max, exp, add, divide per output
                ops, nbytes = 4 * m * px * k + 5 * px * k, 4 * (m * px * k + k + px * k)
                rate = F32_FLOPS_PER_S
            op_ms = ops / rate * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes", ops, nbytes,
                hashed)

    def operator_timing(self):
        """The four operator kernels at the full paper-bayes-fusion batch and at
        its first 65,536 pixels, then the encoders where a launch is small
        (ENCODER_SHAPES): device time per launch (torch.profiler; at the full
        batch and the slice with the L2 flushed before each launch, since the
        slice's 34 MB of pand_popcount input would otherwise stay in the 50 MB
        L2) and per back-to-back call (CUDA events) beside the plain versions
        and bounds.
        It runs before the unfused and wide phases, after which profiler
        sessions drop launches."""
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
            reps = 10 if size == "full" else 50
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
                bound, by, ops, nbytes, hashed = self._op_bound(name, ps, n_bits)
                ms = _device_ms(kernel[name], reps, kernel=f"{name}_kernel", cold=True)
                row = {"pixels": px, "ms": ms,
                       "call_ms": _event_ms(kernel[name], reps), "bound_ms": bound,
                       "bound_by": by, "ops": ops, "bytes": nbytes, "hashed_share": hashed,
                       "plain_ms": _event_ms(plain[name], 3, warmup=1) if size == "line" else None}
                if name == "fusion_map":
                    row["composed_ms"] = _event_ms(lambda: torch.softmax(
                        torch.log(ps.clamp(1e-9, 1.0)).sum(0) - logprior, -1), reps)
                table[name][size] = row
                plain_txt = "not measured (does not fit)" if row["plain_ms"] is None \
                    else f"{row['plain_ms']:.3f} ms"
                extra = f", composed torch {row['composed_ms']:.4f} ms" if "composed_ms" in row else ""
                if hashed is not None:
                    extra += f"; {hashed * 100:.2f}% of streams need a hash"
                self.say(f"{name} {size} ({px} pixels, M={m} K={k} n_bits={n_bits}): kernel "
                         f"{row['ms']:.4f} ms/launch on the device, {row['call_ms']:.4f} ms per "
                         f"back-to-back call, plain {plain_txt}, bound {bound:.4f} ms ({by}; "
                         f"{row['ms'] / bound:.2f}x){extra}")
            del words
        for name, size, shape in ENCODER_SHAPES:
            table[name][size] = self._encoder_row(name, size, *shape)
        table["fusion_map"]["fig4"] = self._fig4_row()
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

    def _fig4_row(self):
        """A Fig 4 scene (64x64 pixels, M = 2, K = 2) through the whole
        ``ops.fusion_map`` call with no prior, as the paper layer calls it:
        its launches per call, ms per call by CUDA events and the kernel's
        device time, the L2 flushed before each launch."""
        gen = torch.Generator(device="cuda").manual_seed(48)
        p = torch.rand((2, FIG4_PIXELS, 2), generator=gen, device="cuda")
        before = fm_kernel.fusion_map_cuda.launches
        fusion_map(p)
        launches = fm_kernel.fusion_map_cuda.launches - before
        bound, by, ops, nbytes, _ = self._op_bound("fusion_map", p, 0)
        row = {"shape": list(p.shape), "launches_per_call": launches,
               "call_ms": _event_ms(lambda: fusion_map(p), 50),
               "ms": _device_ms(lambda: fusion_map(p), kernel="fusion_map_kernel", cold=True),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "route": fm_kernel.route(p, torch.empty_like(p[0]))}
        if launches != 1:
            raise AssertionError(f"ops.fusion_map launched {launches} kernels in a call, not 1")
        self.say(f"fusion_map fig4 (ops.fusion_map, M=2 R={FIG4_PIXELS} K=2, no prior, "
                 f"{row['route']} kernel): {launches} launch per call, {row['call_ms']:.4f} ms per "
                 f"call, {row['ms']:.4f} ms on the device, bound {bound:.6f} ms ({by})")
        return row

    def _encoder_row(self, name, size, m, r, k, n_bits):
        """One encoder launch of shape (M, R, K) at n_bits, timed (sne_encode
        encodes the M * R * K streams)."""
        kd = rng.seed_words(NM_KEY)
        p = torch.rand((m, r, k), generator=torch.Generator(device="cuda").manual_seed(47),
                       device="cuda")
        bound, by, ops, nbytes, hashed = self._op_bound(name, p, n_bits)
        if name == "sne_encode":
            flat = p.reshape(-1)

            def launch():
                return sne_kernel.sne_encode_cuda(*kd, flat, n_bits=n_bits)

            def plain():
                return sne_encode_ref(flat, _entropy(NM_KEY, (flat.numel(),), n_bits, 0))
        else:
            def launch():
                return bd_kernel.bayes_decide_cuda(*kd, p, n_bits=n_bits)

            def plain():
                return bayes_decide_ref(p, _entropy(NM_KEY, (m, r, k), n_bits, 0))
        row = {"shape": [m, r, k], "n_bits": n_bits,
               "ms": _device_ms(launch, kernel=f"{name}_kernel"),
               "call_ms": _event_ms(launch, 50), "bound_ms": bound, "bound_by": by,
               "ops": ops, "bytes": nbytes, "hashed_share": hashed,
               "plain_ms": _event_ms(plain, 3, warmup=1)}
        self.say(f"{name} {size} (M={m} R={r} K={k}, n_bits={n_bits}): kernel {row['ms']:.4f} "
                 f"ms/launch on the device, {row['call_ms']:.4f} ms per back-to-back call, "
                 f"plain {row['plain_ms']:.3f} ms, bound {bound:.5f} ms ({by}; "
                 f"{row['ms'] / bound:.2f}x; {hashed * 100:.2f}% of streams need a hash)")
        return row

    # ---------------------------------------------------------- unfused lowering
    def _nm_note(self, name, got, want):
        err = _int_err(got, want)
        self.nm_err[name] = max(self.nm_err[name], err)
        if err:
            raise AssertionError(f"{name} differs from its plain version: max abs err {err}")

    def unfused_kernels(self):
        """Each node_mux kernel against its plain version on the same inputs, on the card."""
        self.nm_err = {name: 0 for name in NM_KERNELS + WIDE_KERNELS}
        gen = torch.Generator(device="cuda").manual_seed(31)
        kd = rng.seed_words(NM_KEY)
        half_steps = (2 * torch.arange(8, device="cuda") + 1) / 512
        # (parents, rows, n_bits, counter origin)
        binary = [(0, 333, 128, 0), (1, BATCH, N_BITS, 0), (2, BATCH, N_BITS, NM_WRAP),
                  (3, BATCH, N_BITS, 0), (3, 1000, N_BITS, NM_WRAP), (4, 500, 1024, 0),
                  (5, 300, 512, NM_WRAP), (6, 300, 256, NM_WRAP)]
        for m, rows, n_bits, off in binary:
            cpt = torch.rand((rows, 1 << m), generator=gen, device="cuda")
            cpt.view(-1)[:8] = half_steps[: cpt.numel()]
            cpt[-1] = 1.0
            par = _rand_words(gen, (m, rows, n_bits // 32))
            # per-row tables, then shared rows (stride 0) holding 0, 128, 256 and half steps
            for table in [cpt] + [row.expand(rows, -1) for row in _edge_rows(m)]:
                self._nm_note("node_mux_gather",
                              nm_kernel.node_mux_gather_cuda(*kd, table, par, n_bits=n_bits,
                                                             offset=off),
                              node_mux_gather_ref(table, _entropy(NM_KEY, (rows,), n_bits, off),
                                                  par))
                want = node_mux_ref(table, _entropy(NM_KEY, (rows, 1 << m), n_bits, off), par)
                self._nm_note("node_mux_rows",
                              nm_kernel.node_mux_rows_cuda(*kd, table, par, n_bits=n_bits,
                                                           offset=off), want)
        # the wide paths: 7 and 8 binary parents (the gather on the pattern-table
        # kernel at k = 2, rows; shared CPT rows too)
        for m, rows, n_bits, off in ((7, 300, 256, NM_WRAP), (8, 64, N_BITS, 0)):
            cpt = torch.rand((rows, 1 << m), generator=gen, device="cuda")
            cpt.view(-1)[:8] = half_steps
            par = _rand_words(gen, (m, rows, n_bits // 32))
            for table in (cpt, cpt[:1].expand(rows, -1)):
                self._nm_note("node_mux_cat",
                              nm_kernel.node_mux_gather_cuda(*kd, table, par, n_bits=n_bits,
                                                             offset=off),
                              node_mux_gather_ref(table, _entropy(NM_KEY, (rows,), n_bits, off),
                                                  par))
            self._nm_note("node_mux_rows_wide",
                          nm_kernel.node_mux_rows_cuda(*kd, cpt, par, n_bits=n_bits, offset=off),
                          node_mux_ref(cpt, _entropy(NM_KEY, (rows, 1 << m), n_bits, off), par))
        # (cards, rows, n_bits, counter origin): obstacle-class's rgb_class, k-ary
        # roots (no parents), parents of card 3 (their planes spell digit 3), 6
        # binary parents at k = 2 (a 6-parent gather's pattern-table route), then
        # the wide path: 9 planes (above the pattern table's 8) and 17 parents
        cat = [((4, 4, 2), BATCH, N_BITS, 0), ((3,), BATCH, N_BITS, NM_WRAP), ((4,), 257, 128, 0),
               ((3, 3, 2), 1000, N_BITS, NM_WRAP), ((2, 3, 2, 2), BATCH, 256, 0),
               ((5, 2, 2, 2, 2), 300, 256, NM_WRAP), ((2,) * 7, 300, 256, NM_WRAP),
               ((3,) + (2,) * 9, 64, 256, NM_WRAP),
               ((3, 4, 3) + (2,) * 5, 32, 128, 0), ((3,) + (2,) * 17, 8, 64, NM_WRAP)]
        for cards, rows, n_bits, off in cat:
            k, pcards = cards[0], cards[1:]
            n_leaves = int(np.prod(pcards)) if pcards else 1
            planes = sum(bitops.value_bits(c) for c in pcards)
            name = "node_mux_cat_wide" if planes > 8 else "node_mux_cat"
            levels = torch.randint(0, 257, (rows, n_leaves, k - 1), generator=gen, device="cuda")
            cdf = torch.sort(levels, dim=-1, descending=True).values.to(torch.int32)
            par = _rand_words(gen, (planes, rows, n_bits // 32))
            for table in (cdf, cdf[:1].expand(rows, -1, -1)):      # per row, and shared
                self._nm_note(name,
                              nm_kernel.node_mux_cat_cuda(*kd, cat_table(table, cards), par,
                                                          cards=cards, n_bits=n_bits, offset=off),
                              cat_gather_body(table, _entropy(NM_KEY, (rows,), n_bits, off), par,
                                              cards))
        torch.cuda.synchronize()
        print(f"node_mux: {len(binary)} gather and rows cases (0-6 parents, per-row tables and "
              f"shared rows holding thresholds 0, 128, 256 and the half steps), 2 wide (7 and 8 parents; "
              f"the gather on the cat kernel), "
              f"{len(cat)} cat cases x per-row and shared tables (0-6 parents, k-ary roots, "
              f"9 planes, 17 parents, counter origins wrapping 2**32) equal to the plain "
              f"versions: max abs err {self.nm_err} (tolerance 0: packed words must match "
              f"exactly)", flush=True)

    def unfused_path(self):
        """The unfused lowering through its entry points, against device="cpu"."""
        cases = [(n, "unfused") for n in NAMES] + [(n, "shared") for n in NAMES]
        cases += [(n, "rows") for n in NAMES if by_name(n).max_card() == 2]
        cases += [("pedestrian-night", "fill"), ("obstacle-class", "fill")]
        key = prng.PRNGKey(23)
        ev = {n: analytic.sample_evidence(by_name(n), prng.PRNGKey(11), BATCH,
                                          device="cpu").numpy() for n in NAMES}
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

    def wide_path(self):
        """The wide networks through their entry points, on the card against device="cpu"."""
        key = prng.PRNGKey(31)
        # mode -> (network, compile_network keywords); rows takes binary networks only
        wide = _spec("wide")
        modes = {"fused": (wide, {}), "unfused": (wide, dict(fused=False)),
                 "shared": (wide, dict(share_entropy=True)),
                 "rows": (wide_spec(tbn, 7), dict(mux_mode="rows"))}
        ev = {m: analytic.sample_evidence(spec, prng.PRNGKey(12), BATCH, device="cpu").numpy()
              for m, (spec, _) in modes.items()}
        want = {m: compile_network(spec, n_bits=N_BITS, device="cpu", **kw).decide(key, ev[m])
                for m, (spec, kw) in modes.items()}
        nets = {m: compile_network(spec, n_bits=N_BITS, device="cuda", **kw)
                for m, (spec, kw) in modes.items()}
        torch.cuda.synchronize()
        _reset_launches()                                    # the wide path starts
        got = {m: [t.cpu() for t in net.decide(key, ev[m])] for m, net in nets.items()}
        torch.cuda.synchronize()
        self.wide_launches = _launches()                     # the wide path ends
        for name in WIDE_KERNELS + ("net_sweep", "node_mux_gather", "node_mux_cat",
                                    "sne_encode"):
            if self.wide_launches[name] <= 0:
                raise AssertionError(f"the wide path launched {name} 0 times")
        for m in modes:
            for g, w in zip(got[m], want[m]):
                if not torch.equal(g, w):
                    raise AssertionError(f"wide network {m}: the card differs from device='cpu'")
            post = got[m][0]
            if not (bool(torch.isfinite(post).all()) and float(post.min()) >= 0
                    and float(post.max()) <= 1):
                raise AssertionError(f"wide network {m}: posterior not in [0, 1]")
        prog = record_program(nets["fused"].plan)
        self.say(f"wide path: {modes['fused'][0].name} (a 7-parent binary node, a 3-valued "
                 f"node with 9 binary parents; fused program {len(prog.code)} gates, "
                 f"{prog.n_slots} live words) fused, fused=False and share_entropy=True, and "
                 f"{modes['rows'][0].name} with mux_mode='rows', at n_bits={N_BITS}, "
                 f"B={BATCH}: decide equal to device='cpu'; launches {self.wide_launches}")
        self.report["wide_path"] = {"launches": self.wide_launches, "gates": len(prog.code),
                                    "live_words": prog.n_slots}

    def _nm_bound(self, rows, k, planes, n_bits, table_bytes, hashed=None):
        """(bound ms, what sets it, operations, bytes) of one node_mux launch.

        One hash per entropy word the function needs -- ``hashed`` for
        row-encode (:func:`_selected_leaf_words`), one per 4 stream bits
        otherwise -- and one compare per stream bit and level.  Bytes: the
        node's one table, the parents' words in and the node's words out.
        """
        w = n_bits // 32
        words = rows * w * 8
        hashed = words if hashed is None else hashed
        ops = hashed * NM_HASH_OPS + words * 4 * (k - 1)
        nbytes = table_bytes + 4 * rows * w * (planes + bitops.value_bits(k))
        op_ms = ops / self.int32_ops_per_s * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), ops, nbytes

    def binary_timing(self):
        """The binary gather and row encode per parent count (BINARY_NODES), at
        B=1024 and B=65,536 with the node's one table (stride 0): device time
        per launch beside the bound; beside the gather the pattern-table route
        (``node_mux_cat`` on the table folded beforehand), and the row encode.
        The pattern-table route is held equal to the gather first."""
        kd = rng.seed_words(NM_KEY)
        gen = torch.Generator(device="cuda").manual_seed(43)
        w = N_BITS // 32
        out = {}
        for m, (scen, node) in BINARY_NODES.items():
            cpt, pcards, _ = _node_table(scen, node)
            folded, cards = binary_cat_table(cpt), (2,) * (m + 1)
            out[m] = {}
            for b in (BATCH, NM_BIG):
                par = _rand_words(gen, (m, b, w))
                table = cpt.expand(b, -1)
                calls = {
                    "gather": lambda: nm_kernel.node_mux_gather_cuda(*kd, table, par,
                                                                     n_bits=N_BITS),
                    "pattern_table": lambda: nm_kernel.node_mux_cat_cuda(
                        *kd, folded, par, cards=cards, n_bits=N_BITS),
                    "rows": lambda: nm_kernel.node_mux_rows_cuda(*kd, table, par, n_bits=N_BITS),
                }
                if _int_err(calls["pattern_table"]()[0], calls["gather"]()):
                    raise AssertionError(f"{scen}/{node} B={b}: the pattern-table route "
                                         f"differs from the gather")
                gather_bound = self._nm_bound(b, 2, m, N_BITS, cpt.numel() * 4)
                hashed = _selected_leaf_words(par)
                rows_bound = self._nm_bound(b, 2, m, N_BITS, cpt.numel() * 4, hashed)
                row = {"node": f"{scen}/{node}", "parents": m, "rows": b,
                       "gather_bound_ms": gather_bound[0], "rows_bound_ms": rows_bound[0],
                       "bound_by": gather_bound[1], "rows_hashed_words": hashed}
                for name, call in calls.items():
                    row[f"{name}_ms"] = _device_ms(call)
                if b == BATCH:
                    def gather_plain():
                        rand = _entropy(NM_KEY, (b,), N_BITS, 0)
                        return node_mux_gather_ref(table, rand, par)

                    def rows_plain():
                        rand = _entropy(NM_KEY, (b, 1 << m), N_BITS, 0)
                        return node_mux_ref(table, rand, par)

                    row["gather_plain_ms"] = _event_ms(gather_plain, 3, warmup=1)
                    row["rows_plain_ms"] = _event_ms(rows_plain, 3, warmup=1)
                out[m][b] = row
                ms = {k: f"{row[f'{k}_ms']:.4f}" for k in calls}
                self.say(f"binary node {scen}/{node} ({m} parents) B={b} n_bits={N_BITS}, "
                         f"device ms per launch: gather {ms['gather']} "
                         f"({row['gather_ms'] / gather_bound[0]:.2f}x its bound "
                         f"{gather_bound[0]:.4f}), pattern table {ms['pattern_table']}; rows "
                         f"{ms['rows']} ({row['rows_ms'] / rows_bound[0]:.2f}x its bound "
                         f"{rows_bound[0]:.4f})")
                del par, table, calls
        self.report["binary_timing"] = out

    def unfused_timing(self):
        kd = rng.seed_words(NM_KEY)
        gen = torch.Generator(device="cuda").manual_seed(41)
        nodes = {"node_mux_gather": ("intersection", "rgb_cross"),
                 "node_mux_rows": ("intersection", "rgb_cross"),
                 "node_mux_cat": ("obstacle-class", "rgb_class"),
                 "node_mux_rows_wide": ("wide", "hub"),
                 "node_mux_cat_wide": ("wide", "cls")}
        table = {name: {} for name in nodes}
        w = N_BITS // 32
        sizes = [(b, name) for b in (BATCH, NM_BIG) for name in NM_KERNELS]
        sizes += [(WIDE_BATCH, name) for name in WIDE_KERNELS]
        for b, name in sizes:
            scen, node = nodes[name]
            tab, pcards, card = _node_table(scen, node)
            planes = sum(bitops.value_bits(c) for c in pcards)
            par = _rand_words(gen, (planes, b, w))
            n_leaves = tab.shape[0]
            kernel, plain = _nm_calls(name, kd, tab, par, (card,) + pcards, b)
            rows_mode = name.startswith("node_mux_rows")
            hashed = _selected_leaf_words(par) if rows_mode else None
            tab_bytes = n_leaves * (card - 1) * 4
            if name == "node_mux_cat":                          # the int16 pattern table
                tab_bytes = (1 << planes) * (card - 1) * 2
            bound, by, ops, nbytes = self._nm_bound(b, card, planes, N_BITS, tab_bytes, hashed)
            kernel_hashed = b * w * 8
            if name == "node_mux_rows":
                kernel_hashed *= n_leaves
            elif name == "node_mux_rows_wide":
                kernel_hashed *= 4                            # one word per stream position
            row = {"rows": b, "node": f"{scen}/{node}", "ms": _device_ms(kernel),
                   "call_ms": _event_ms(kernel, 50),
                   "bound_ms": bound, "bound_by": by, "ops": ops, "bytes": nbytes,
                   "hashed_words": hashed or b * w * 8, "kernel_hashed_words": kernel_hashed,
                   "plain_ms": _event_ms(plain, 3, warmup=1) if b <= BATCH else None}
            table[name][b] = row
            plain_txt = "not measured (B=1024 only)" if row["plain_ms"] is None \
                else f"{row['plain_ms']:.3f} ms"
            self.say(f"{name} {scen}/{node} B={b} n_bits={N_BITS}: kernel {row['ms']:.4f} "
                     f"ms/launch on the device, {row['call_ms']:.4f} ms per back-to-back call, "
                     f"plain {plain_txt}, bound {bound:.4f} ms ({by}; "
                     f"{row['ms'] / bound:.2f}x; {row['hashed_words']} entropy words needed, "
                     f"the kernel hashes {row['kernel_hashed_words']})")
            del par, tab, kernel, plain
        # the 7-parent binary gather as a compiled network runs it: the cat
        # kernel at k = 2 on the table folded at compile time
        cpt, pcards, _ = _node_table("wide", "hub")
        folded, cards = binary_cat_table(cpt), (2,) * (len(pcards) + 1)
        par = _rand_words(gen, (len(pcards), WIDE_BATCH, w))

        def kernel():
            return nm_kernel.node_mux_cat_cuda(*kd, folded, par, cards=cards, n_bits=N_BITS)

        def plain():
            rand = _entropy(NM_KEY, (WIDE_BATCH,), N_BITS, 0)
            return node_mux_gather_ref(cpt.expand(WIDE_BATCH, -1), rand, par)

        self._nm_note("node_mux_cat", kernel()[0], plain())
        bound, by, ops, nbytes = self._nm_bound(WIDE_BATCH, 2, len(pcards), N_BITS,
                                                folded.numel() * 2)
        row = {"rows": WIDE_BATCH, "node": "wide/hub", "ms": _device_ms(kernel),
               "call_ms": _event_ms(kernel, 50), "bound_ms": bound, "bound_by": by,
               "ops": ops, "bytes": nbytes, "plain_ms": _event_ms(plain, 3, warmup=1)}
        table["node_mux_cat"]["wide/hub"] = row
        self.say(f"node_mux_cat wide/hub (7 binary parents, the gather's table folded "
                 f"beforehand) B={WIDE_BATCH} n_bits={N_BITS}: kernel {row['ms']:.4f} ms/launch "
                 f"on the device, {row['call_ms']:.4f} ms per back-to-back call, plain "
                 f"{row['plain_ms']:.3f} ms, bound {bound:.4f} ms ({by}; "
                 f"{row['ms'] / bound:.2f}x)")
        del par, folded, kernel, plain
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
    only = None
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        only = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--phases name[,name...]]", file=sys.stderr)
        return 2
    s = Smoke()

    def run(name, *needs):
        if (only is None or name in only) and not set(needs) & set(s.failures):
            s.phase(name, getattr(s, name))

    s.phase("device", s.device)
    try:
        if only is None or "dryrun" in only:
            s.start_dryrun_early()
        run("build")
        for name in ("kernels", "main_path", "timing", "binary_timing", "drain_trace", "router",
                     "reliability", "drift", "paper_layer", "lm_serve", "lm_blocks", "lm_train",
                     "multi_device"):
            run(name, "build")
        run("dryrun")
        run("operators", "build")
        run("operator_timing", "build", "operators")
        run("unfused_kernels", "build")
        run("unfused_path", "build", "unfused_kernels")
        run("wide_path", "build")
        run("unfused_timing", "build", "unfused_path", "wide_path")
    finally:
        s.stop()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    s.report["profiler_dropped"] = PROFILER_DROPPED
    print(f"torch.profiler: {len(PROFILER_DROPPED)} kernels timed, launches not recorded "
          f"{sum(PROFILER_DROPPED)} of {50 * len(PROFILER_DROPPED)}, at most "
          f"{max(PROFILER_DROPPED, default=0)} in a session")
    (out_dir / "chip_smoke.json").write_text(json.dumps(s.report, indent=1, default=str))
    if s.failures:
        print(f"chip_smoke: FAILED phases: {', '.join(s.failures)}", file=sys.stderr)
        return 1
    if only is not None:
        print(s.name_power)
        print(json.dumps({name: s.report.get(name) for name in sorted(only)}, default=str))
        return 0
    t = s.report["net_sweep"][TIMED_SCENARIO][BATCH]
    kernels = {"kernels": [{
        "name": "net_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/net_sweep/csrc/net_sweep_kernel.cuh",
        "replaces": REPLACES["net_sweep"],
        "launches": s.launches,
        "max_abs_err": s.max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "at": f"{TIMED_SCENARIO} B={BATCH} n_bits={N_BITS}",
        "call_ms": t["call_ms"],
        "router_launches": s.router_launches,
        "reliability_launches": s.rel_launches,
        "drift_launches": s.drift_launches,
        "multi_device_launches_per_rank": s.md_launches,
        "ms_b256": s.report["net_sweep"][TIMED_SCENARIO][MAX_BATCH]["ms"],
        "bound_ms_b256": s.report["net_sweep"][TIMED_SCENARIO][MAX_BATCH]["bound_ms"],
        "source_generated": "src/repro_torch/kernels/net_sweep/codegen.py",
    }]}
    for name, sizes in s.report["operator_timing"].items():
        line, full = sizes["line"], sizes["full"]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": s.op_launches[name],
            "max_abs_err": s.op_err[name], "ms": line["ms"], "call_ms": line["call_ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"],
            "library_ms": None,   # no single PyTorch call computes it
            "at": f"paper-bayes-fusion M=2 K=16 n_bits=128, first {LINE_PIXELS} pixels",
            "full_ms": full["ms"], "full_call_ms": full["call_ms"],
            "full_bound_ms": full["bound_ms"],
        }
        if name == "bayes_decide":   # at the LM engine's gate (lm_serve) and the MTP fusion
            entry.update(lm_gate_ms=s.lm_gate["ms"], lm_gate_bound_ms=s.lm_gate["bound_ms"],
                         lm_gate_launches=s.lm_gate["launches"],
                         lm_blocks_gate_launches={a: s.report["lm_blocks"][a]["gate"]["launches"]
                                                  for a in BLOCKS_SERVED},
                         mtp_gate_ms=s.mtp_gate["ms"], mtp_gate_bound_ms=s.mtp_gate["bound_ms"],
                         mtp_gate_launches=s.mtp_gate["launches"])
        if name == "fusion_map":
            fig4 = sizes["fig4"]
            entry.update(composed_ms=line["composed_ms"], full_composed_ms=full["composed_ms"],
                         routes=s.report["fusion_map_routes"], fig4_call_ms=fig4["call_ms"],
                         fig4_ms=fig4["ms"], fig4_bound_ms=fig4["bound_ms"],
                         fig4_launches_per_call=fig4["launches_per_call"])
        for kernel, size, _ in ENCODER_SHAPES:
            if kernel == name:
                entry[f"{size}_ms"] = sizes[size]["ms"]
                entry[f"{size}_bound_ms"] = sizes[size]["bound_ms"]
        kernels["kernels"].append(entry)
    for name, sizes in s.report["unfused_timing"]["kernels"].items():
        wide = name in WIDE_KERNELS
        row = sizes[WIDE_BATCH if wide else BATCH]
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/node_mux/csrc/node_mux.cu",
            "replaces": REPLACES[name],
            "launches": (s.wide_launches if wide else s.nm_launches)[name],
            "max_abs_err": s.nm_err[name], "ms": row["ms"], "call_ms": row["call_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,   # no PyTorch call computes it
            "at": f"{row['node']} B={row['rows']} n_bits={N_BITS}",
        }
        if not wide:
            entry.update(ms_65536=sizes[NM_BIG]["ms"], bound_ms_65536=sizes[NM_BIG]["bound_ms"])
        if name in ("node_mux_gather", "node_mux_rows"):   # per parent count, B=65,536
            kind = name.split("_")[-1]
            entry["by_parents_65536"] = {
                m: {"ms": by_b[NM_BIG][f"{kind}_ms"], "bound_ms": by_b[NM_BIG][f"{kind}_bound_ms"]}
                for m, by_b in s.report["binary_timing"].items()}
        kernels["kernels"].append(entry)
    print(f"net_sweep programs built in this run: {net_sweep_kernel.net_sweep_cuda.builds}")
    print(s.name_power)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
