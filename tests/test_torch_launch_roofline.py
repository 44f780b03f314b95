"""The H100 roofline (``repro_torch.launch.roofline``) and its step counter.

- ``Roofline.finalize`` equals the reference's ``repro.launch.roofline``
  with the reference's constants swapped for the H100's (its single link rate
  for the one link class that carries every collective byte), exactly.
- The collective rule (all-reduce 2x its result, the other kinds 1x) equals
  the reference's HLO parser on the reference's own HLO sample.
- Counts on constructed cases, in a fake world (``torch.distributed``'s fake
  backend under ``FakeTensorMode``) run in a subprocess with a timeout: a
  column- and a row-parallel product on a (2, 2) mesh count ``2mnk / shards``
  FLOPs per device, the row-parallel all-reduce 2x its local result, an
  all-gather its result; the port's own c10d calls are counted; a 1-rank
  mesh counts what no mesh counts; a (2, 8) mesh's ``model`` groups ride
  NVLink and its ``data`` groups InfiniBand.
- ``dryrun.calibrate`` (repetitions 1 and 2, extrapolated) equals the count
  at full depth on the ten smoke configs, with no mesh: FLOPs, bytes, the
  peak of live storage and the params' and optimizer's bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import repro.launch.roofline as ref_rf
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, mesh as h100, roofline as rf

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 240

# the reference's HLO sample (tests/distributed/test_roofline_parse.py) ...
HLO = """
  %ag = bf16[16,4096,8192]{2,1,0} all-gather(%p0), replica_groups={{0,1}}
  %ar.1 = f32[1024,512]{1,0} all-reduce(%x1), to_apply=%add
  %ars = f32[1024,512]{1,0} all-reduce-start(%x2), to_apply=%add
  %ard = f32[1024,512]{1,0} all-reduce-done(%ars)
  %rs = bf16[8,128]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = s32[64]{0} all-to-all(%z), dimensions={0}
  %cp = u32[32,4]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %tup = (f32[2,2]{1,0}, f32[2,2]{1,0}) all-reduce(%a, %b), to_apply=%add
"""


def _records():
    """... as the port's records (the tuple all-reduce is two results)."""
    import torch

    def c(kind, shape, dtype):
        return rf.Collective(kind, shape, dtype, "model", "nvlink")

    return [c("all-gather", (16, 4096, 8192), torch.bfloat16),
            c("all-reduce", (1024, 512), torch.float32),
            c("all-reduce", (1024, 512), torch.float32),
            c("reduce-scatter", (8, 128), torch.bfloat16),
            c("all-to-all", (64,), torch.int32),
            c("collective-permute", (32, 4), torch.int32),
            c("all-reduce", (2, 2), torch.float32), c("all-reduce", (2, 2), torch.float32)]


def test_collective_rule_equals_the_reference_parser():
    total, by_kind = rf.collective_bytes(_records())
    ref_total, ref_by_kind = ref_rf.collective_bytes(HLO)
    assert (total, by_kind) == (ref_total, ref_by_kind)
    counts = rf.collective_counts(_records())
    ref_counts = ref_rf.collective_counts(HLO)
    # the reference counts the tuple all-reduce once; the port, one record per result
    assert counts == {**ref_counts, "all-reduce": ref_counts["all-reduce"] + 1}
    assert rf.collective_by_link(_records()) == {"nvlink": total, "ib": 0}


def test_h100_constants_are_the_data_sheet_s():
    assert (h100.PEAK_FLOPS_BF16, h100.HBM_BW, h100.NVLINK_BW, h100.IB_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert h100.PRODUCTION_MESHES == {
        False: ("h100x32x8", (32, 8), ("data", "model")),
        True: ("h100x2x16x8", (2, 16, 8), ("pod", "data", "model"))}


@pytest.mark.parametrize("link", ["nvlink", "ib"])
@pytest.mark.parametrize("flops,nbytes,cbytes,mflops", [
    (989e12, 3.35e12, 450e9, 989e12 * 256 / 2),      # all three terms equal
    (5e15, 1e12, 1e9, 1e17),                          # compute-bound
    (1e12, 4e13, 3e9, 3e14),                          # memory-bound
    (1e12, 1e12, 7.5e11, 0.0),                        # collective-bound, no model FLOPs
    (0.0, 2e9, 0.0, 1e12),                            # no FLOPs (the fusion workload)
])
def test_finalize_equals_the_reference_with_h100_constants(monkeypatch, link, flops, nbytes,
                                                           cbytes, mflops):
    rate = h100.NVLINK_BW if link == "nvlink" else h100.IB_BW
    monkeypatch.setattr(ref_rf, "PEAK_FLOPS_BF16", h100.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref_rf, "HBM_BW", h100.HBM_BW)
    monkeypatch.setattr(ref_rf, "ICI_BW", rate)
    kw = dict(arch="x", shape="train_4k", mesh="h100x32x8", chips=256, flops_per_chip=flops,
              bytes_per_chip=nbytes, collective_bytes_per_chip=cbytes,
              collective_by_kind={"all-gather": cbytes}, model_flops_total=mflops)
    ref = ref_rf.Roofline(**kw).finalize().to_dict()
    got = rf.Roofline(**kw, collective_by_link={"nvlink": 0, "ib": 0, link: cbytes}).finalize()
    got = got.to_dict()
    assert got.pop("collective_by_link") == {"nvlink": 0, "ib": 0, link: cbytes}
    assert got == ref


def test_collective_term_adds_the_two_links():
    r = rf.Roofline(arch="x", shape="s", mesh="m", chips=16, flops_per_chip=0.0,
                    bytes_per_chip=0.0, collective_bytes_per_chip=500e9,
                    collective_by_kind={"all-reduce": 500e9},
                    collective_by_link={"nvlink": 450e9, "ib": 50e9},
                    model_flops_total=0.0).finalize()
    assert r.collective_s == 2.0 and r.bottleneck == "collective"
    with pytest.raises(ValueError, match="do not add up"):
        rf.Roofline(arch="x", shape="s", mesh="m", chips=16, flops_per_chip=0.0,
                    bytes_per_chip=0.0, collective_bytes_per_chip=1.0,
                    collective_by_kind={}, collective_by_link={"nvlink": 0, "ib": 0},
                    model_flops_total=0.0).finalize()


def test_link_of_a_group():
    assert rf.link_of(range(8)) == "nvlink"
    assert rf.link_of(range(8, 16)) == "nvlink"
    assert rf.link_of([0, 8]) == "ib"
    assert rf.link_of(range(4, 12)) == "ib"


# ------------------------------------------------------------ constructed cases

WORLD = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.dryrun import count_step, fake_world
    from repro_torch.launch.mesh import make_test_mesh

    M, K, N = 64, 96, 80
    out = {}

    def counted(fn, mesh=None):
        c = count_step(fn, (), mesh)
        return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
                "records": [[r.kind, list(r.shape), r.dtype.itemsize, r.axis, r.link]
                            for r in c.records]}

    with fake_world(4):
        mesh = make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cpu")
        fake = FakeTensorMode()
        fake.__enter__()
        x, w = torch.zeros(M, K), torch.zeros(K, N)
        def col():        # x replicated, w's columns over model
            xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
            wd = DTensor.from_local(w[:, :N // 2], mesh, [Replicate(), Shard(1)], run_check=False)
            assert (xd @ wd).placements == (Replicate(), Shard(1))
        def row():        # x's columns and w's rows over model, the partial sum reduced
            xd = DTensor.from_local(x[:, :K // 2], mesh, [Replicate(), Shard(1)], run_check=False)
            wd = DTensor.from_local(w[:K // 2], mesh, [Replicate(), Shard(0)], run_check=False)
            (xd @ wd).redistribute(mesh, [Replicate(), Replicate()])
        def gather():     # rows over data, gathered
            DTensor.from_local(x[:M // 2], mesh, [Shard(0), Replicate()],
                               run_check=False).redistribute(mesh, [Replicate(), Replicate()])
        t, gathered, moved = torch.zeros(M, N), torch.zeros(2 * M, N), torch.zeros(M, N)
        def c10d():       # the port's own collective calls on the data group
            g = mesh.get_group("data")
            dist.all_reduce(t, group=g)
            dist.all_gather_into_tensor(gathered, t, group=g)
            dist.all_to_all_single(moved, t, group=g)
        a, b = torch.zeros(M, K), torch.zeros(M, K)
        def add_and_views():
            (a + b).view(-1).unsqueeze(0).t()
            a.t()
        def meta():       # a template of shapes (a decode state placed by sharding.place_state)
            (torch.zeros(M, K, device="meta") + torch.full((M, K), -1, device="meta")).sum()
        for name, fn in [("col", col), ("row", row), ("gather", gather), ("c10d", c10d),
                         ("add", add_and_views), ("meta", meta)]:
            with dctx.mesh_context(mesh):
                out[name] = counted(fn, mesh)
        out["plain_col"] = counted(lambda: x @ w[:, :N // 2])
        fake.__exit__(None, None, None)
    with fake_world(1):
        one = make_test_mesh(shape=(1,), axes=("model",), device="cpu")
        fake.__enter__()
        x, w = torch.zeros(M, K), torch.zeros(K, N)
        def one_rank():
            xd = DTensor.from_local(x, one, [Replicate()], run_check=False)
            wd = DTensor.from_local(w, one, [Shard(1)], run_check=False)
            (xd @ wd).redistribute(one, [Replicate()])
        with dctx.mesh_context(one):
            out["one_rank"] = counted(one_rank, one)
        out["no_mesh"] = counted(lambda: x @ w)
        fake.__exit__(None, None, None)
    with fake_world(16):
        mesh = make_test_mesh(shape=(2, 8), axes=("data", "model"), device="cpu")
        fake.__enter__()
        def links():
            t = torch.zeros(M, N)
            for ax in ("data", "model"):
                dist.all_reduce(t, group=mesh.get_group(ax))
        out["links"] = counted(links, mesh)
        fake.__exit__(None, None, None)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def world():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", WORLD], env=env, capture_output=True,
                          text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


M, K, N = 64, 96, 80


def test_column_parallel_product_counts_its_shard(world):
    got = world["col"]
    assert got["flops"] == 2 * M * N * K // 2
    assert got["records"] == []
    assert got == {**world["plain_col"], "peak": got["peak"]}


def test_row_parallel_product_and_its_all_reduce(world):
    got = world["row"]
    assert got["flops"] == 2 * M * N * K // 2
    assert got["records"] == [["all-reduce", [M, N], 4, "model", "nvlink"]]
    assert rf.Collective("all-reduce", (M, N), __import__("torch").float32, "model",
                         "nvlink").moved == 2 * M * N * 4


def test_all_gather_counts_its_result(world):
    assert world["gather"]["records"] == [["all-gather", [M, K], 4, "data", "nvlink"]]
    assert world["gather"]["flops"] == 0


def test_the_ports_own_c10d_calls_are_counted(world):
    assert world["c10d"]["records"] == [["all-reduce", [M, N], 4, "data", "nvlink"],
                                        ["all-gather", [2 * M, N], 4, "data", "nvlink"],
                                        ["all-to-all", [M, N], 4, "data", "nvlink"]]
    assert world["c10d"]["bytes"] == 0


def test_bytes_are_inputs_and_outputs_views_count_nothing(world):
    assert world["add"]["bytes"] == 3 * M * K * 4
    assert world["add"]["flops"] == 0


def test_meta_templates_hold_and_move_nothing(world):
    assert world["meta"] == {"flops": 0, "bytes": 0, "peak": 0, "records": []}


def test_one_rank_mesh_counts_what_no_mesh_counts(world):
    one, none = world["one_rank"], world["no_mesh"]
    assert one["records"] == []
    assert (one["flops"], one["bytes"]) == (none["flops"], none["bytes"]) == \
        (2 * M * N * K, (M * K + K * N + M * N) * 4)


def test_mesh_axes_within_a_node_ride_nvlink(world):
    assert world["links"]["records"] == [["all-reduce", [M, N], 4, "data", "ib"],
                                         ["all-reduce", [M, N], 4, "model", "nvlink"]]


# ------------------------------------------------------------------ calibrate

def _deeper(cfg, reps=3):
    if cfg.family == "audio":
        return dataclasses.replace(cfg, enc_layers=reps, dec_layers=reps, num_layers=2 * reps)
    return dataclasses.replace(cfg, num_layers=len(cfg.prefix_kinds) + reps * len(cfg.pattern))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "paper-bayes-fusion"])
def test_calibrate_equals_the_full_depth_count(arch):
    cfg = _deeper(get_smoke_config(arch))
    # the vlm stub prepends its 256 patch embeddings to the text
    shape = ShapeConfig("mini", 264 if cfg.family == "vlm" else 8, 2, "train")
    full = dryrun._measure(cfg, shape, None, arch, device="cpu")
    cal = dryrun.calibrate(cfg, shape, None, arch, device="cpu")
    keys = ("flops", "bytes", "collective_bytes", "peak_bytes", "params_bytes",
            "optimizer_bytes")
    assert {k: cal[k] for k in keys} == {k: full[k] for k in keys}
    assert full["flops"] > 0 and full["peak_bytes"] > full["params_bytes"] > 0


def test_peak_split_names_the_storages_live_at_the_peak():
    """``launch.peak.PeakSplit`` on plain CPU tensors: the peak is the
    counter's, and the storages live at it are named by shape, dtype and the
    op that made them; a storage freed before the peak is not among them."""
    import torch

    from repro_torch.launch.peak import PeakSplit

    split = PeakSplit(min_bytes=1024, step_bytes=0)
    with split:
        a = torch.ones(1000)                       # 4000 bytes
        b = torch.cat([a, a])                      # 8000 bytes
        del b
        c = a * 2
        d = torch.stack([a, c, a])                 # the peak: a, c, d
    live = {m[:3] for _, m in split.at_peak[1] if m is not None}
    assert split.peak_bytes == split.at_peak[0] == 4000 * 5
    assert live == {((1000,), "float32", "aten.ones.default"),
                    ((1000,), "float32", "aten.mul.Tensor"),
                    ((3, 1000), "float32", "aten.stack.default")}
    assert "aten.stack.default" in split.report()
    del d
