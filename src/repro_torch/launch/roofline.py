"""Roofline terms of one rank's step, counted as the step runs.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs per GPU / 989 TFLOP/s
  memory     = bytes per GPU / 3.35 TB/s
  collective = NVLink bytes per GPU / 450 GB/s + InfiniBand bytes per GPU / 50 GB/s

The reference reads these from a compiled XLA program (``cost_analysis`` and
the partitioned HLO text).  The port runs eagerly, so :class:`StepCounter`, a
``TorchDispatchMode``, counts what one rank really runs, op by op, on its
*local* tensors (a DTensor op is counted where DTensor hands its shards to the
local op; the op on the DTensor itself, whose shapes are global, is not):

- FLOPs by ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm, baddbmm,
  convolution, scaled dot-product attention).  XLA's count also holds
  elementwise work; this one does not.
- Bytes: each op's tensor inputs plus its tensor outputs; views and ops that
  return no tensor count 0.  That is eager torch's traffic, each op reading
  and writing memory, not a fused program's.
- Collectives: every ``_c10d_functional`` op and DTensor's
  ``shard_dim_alltoall`` (its redistributions, including those inside an
  op's dispatch) and every ``c10d`` op (the port's
  own ``all_gather``, ``all_to_all_single`` and ``all_reduce`` calls), each a
  :class:`Collective` record with its kind, result shape and dtype, mesh axis
  and link.  An all-reduce moves 2x its result's bytes per GPU (a ring's
  reduce-scatter then all-gather), an all-gather, reduce-scatter, all-to-all,
  broadcast or permute (send/recv) 1x, as the reference counts HLO.  A group
  that lies within one node of 8 consecutive ranks rides NVLink; any other
  rides InfiniBand.
- Memory: the live storages of the rank's tensors (params, optimizer state
  and inputs given to :meth:`StepCounter.track`, then every op's outputs),
  each counted until it is freed; the peak is the most held at once.  An
  op on the ``meta`` device (a template of shapes, such as the decode state
  that ``sharding.place_state`` places) holds and moves nothing.

Under ``FakeTensorMode`` nothing is allocated, so a 256-GPU step is counted
in one process on any machine.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Dict, Iterable, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import GPUS_PER_NODE, HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16

_FACTOR = {"all-reduce": 2}          # bytes moved per result byte; 1 for the other kinds

# functional collectives (DTensor's): op name -> kind; the result is the op's output
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
}
# c10d ops (ProcessGroup calls): op name -> (kind, the argument that holds the result)
_C10D = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "output_tensors"),
    "_allgather_base_": ("all-gather", "output_tensor"),
    "allgather_into_tensor_coalesced_": ("all-gather", "outputs"),
    "reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "outputs"),
    "alltoall_base_": ("all-to-all", "output"),
    "alltoall_": ("all-to-all", "output_tensors"),
    "broadcast_": ("broadcast", "tensors"),
    "send": ("collective-permute", "tensors"),
    "recv_": ("collective-permute", "tensors"),
}
# DTensor's own: a shard dim moved to another dim over one mesh dim; the result is the output
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank issued: its kind (the reference's HLO names, plus
    ``broadcast``), its result's shape and dtype, the mesh axis of its group
    (``None`` where the group is no single axis of the mesh given to the
    counter) and the link it rides (``"nvlink"`` or ``"ib"``)."""

    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axis: str | None
    link: str

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def moved(self) -> int:
        """Bytes this GPU moves for it."""
        return _FACTOR.get(self.kind, 1) * self.nbytes


def collective_bytes(records: Iterable[Collective]) -> Tuple[int, Dict[str, int]]:
    """Per-device collective bytes moved, in total and by op kind."""
    by_kind: Dict[str, int] = {}
    for r in records:
        by_kind[r.kind] = by_kind.get(r.kind, 0) + r.moved
    return sum(by_kind.values()), by_kind


def collective_counts(records: Iterable[Collective]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for r in records:
        counts[r.kind] = counts.get(r.kind, 0) + 1
    return counts


def collective_by_link(records: Iterable[Collective]) -> Dict[str, int]:
    """Per-device collective bytes moved over NVLink and over InfiniBand."""
    out = {"nvlink": 0, "ib": 0}
    for r in records:
        out[r.link] += r.moved
    return out


def link_of(ranks: Iterable[int]) -> str:
    """``"nvlink"`` for a group within one node of 8 consecutive ranks, else ``"ib"``."""
    return "nvlink" if len({int(r) // GPUS_PER_NODE for r in ranks}) == 1 else "ib"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_by_kind: Dict[str, int]
    collective_by_link: Dict[str, int]
    model_flops_total: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    peak_memory_bytes: float = 0.0

    def finalize(self):
        links = self.collective_by_link
        if sum(links.values()) != self.collective_bytes_per_chip:
            raise ValueError(f"collective bytes by link {links} do not add up to "
                             f"{self.collective_bytes_per_chip}")
        self.compute_s = self.flops_per_chip / PEAK_FLOPS_BF16
        self.memory_s = self.bytes_per_chip / HBM_BW
        self.collective_s = links.get("nvlink", 0) / NVLINK_BW + links.get("ib", 0) / IB_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_chip * self.chips
        self.useful_ratio = self.model_flops_total / total if total > 0 else 0.0
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def counts_of(counter: "StepCounter") -> dict:
    """A counted step's numbers: FLOPs, bytes, collective bytes (in total, by
    kind and by link), collectives by kind, the peak of live storage and the
    largest single storage."""
    cbytes, by_kind = collective_bytes(counter.records)
    return {"flops": counter.flops, "bytes": counter.bytes, "collective_bytes": cbytes,
            "by_kind": by_kind, "by_link": collective_by_link(counter.records),
            "counts": collective_counts(counter.records), "peak_bytes": counter.peak_bytes,
            "largest_bytes": counter.largest_bytes}


def from_counts(arch: str, shape: str, mesh_name: str, chips: int, counts: dict,
                model_flops_total: float) -> Roofline:
    """The roofline of one rank's step from its counts (:func:`counts_of`, or
    an extrapolation of them); the reference's ``from_compiled``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=float(counts["flops"]), bytes_per_chip=float(counts["bytes"]),
        collective_bytes_per_chip=float(counts["collective_bytes"]),
        collective_by_kind=counts["by_kind"], collective_by_link=counts["by_link"],
        model_flops_total=model_flops_total, peak_memory_bytes=float(counts["peak_bytes"]),
    ).finalize()


# ------------------------------------------------------------------ the counter

def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _tensors(tree) -> list:
    """The tensors in ``tree`` (tuples, lists and dicts of them, as an op's
    arguments and results are), found without pytree's per-node bookkeeping:
    the counter runs this on every op.  A loop, not a recursive closure: a
    closure's cycle would keep the tensors alive until the cyclic collector
    ran, and the peak of live storage would count them."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
_OP_NAMES: dict = {}         # op -> (namespace, name) where a collective's namespace, else None


def _collective_name(func):
    if func not in _OP_NAMES:
        ns = func.namespace
        _OP_NAMES[func] = (ns, func._schema.name.split("::")[-1]) \
            if ns in _COLLECTIVE_NAMESPACES else None
    return _OP_NAMES[func]


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _arg(func, args, kwargs, name):
    names = [a.name for a in func._schema.arguments]
    i = names.index(name)
    return args[i] if i < len(args) else kwargs[name]


class StepCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and peak live storage of the ops
    run under it, on local tensors only (see the module's docstring).

    ``mesh`` (a ``DeviceMesh``, optional) names the axis of each collective's
    group.  Enter it inside the ``FakeTensorMode`` of a dry run (or with real
    tensors, where it counts the same way); call :meth:`track` on the tensors
    that live before the step (params, optimizer state, inputs).
    """

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: list[Collective] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.largest_bytes = 0          # the largest single storage seen
        self.result = None              # what the counted step returned (dryrun.count_step)
        self._live: dict = {}
        self._shadow = 0
        self._axis_of: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis_of[mesh.get_group(i).group_name] = name
        self._restore = None

    # DTensor's sharding propagation runs each op once more on fake tensors of
    # the global shapes, to learn the output's shape; those runs are not the
    # rank's work, and are marked while they run
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            raise RuntimeError(f"torch {torch.__version__}: DTensor's ShardingPropagator has no "
                               f"{name}; the counter cannot tell its shape runs from local ops")
        orig = getattr(ShardingPropagator, name)

        @functools.wraps(orig)
        def marked(prop, *a, **kw):
            self._shadow += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self._shadow -= 1

        setattr(ShardingPropagator, name, marked)
        self._restore = lambda: setattr(ShardingPropagator, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    def track(self, *trees):
        """Count the storages of these tensors (DTensors: their shards) as live."""
        for t in _tensors(trees):
            self._track(t._local_tensor if _is_dtensor(t) else t)

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, functools.partial(self._free, key)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self.largest_bytes = max(self.largest_bytes, n)

    def _free(self, key, _ref):
        _, n = self._live.pop(key)
        self.live_bytes -= n

    def _group(self, func, args, kwargs, ns):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        if ns == "c10d":
            pg = dist.ProcessGroup.unbox(_arg(func, args, kwargs, "process_group"))
        else:
            pg = _arg(func, args, kwargs, "group_name")
            pg = _resolve_process_group(pg) if isinstance(pg, str) else pg
        return self._axis_of.get(pg.group_name), link_of(dist.get_process_group_ranks(pg))

    def _collective(self, func, args, kwargs, out) -> bool:
        op = _collective_name(func)
        if op is None:
            return False
        ns, name = op
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, result = _FUNCTIONAL[name], _tensors(out)
        elif ns == "_dtensor" and name in _DTENSOR:
            kind, result = _DTENSOR[name], _tensors(out)
        elif ns == "c10d" and name in _C10D:
            kind, arg = _C10D[name]
            result = _tensors(_arg(func, args, kwargs, arg))
        else:
            return ns in ("_c10d_functional", "c10d")     # wait_tensor and the like: no traffic
        axis, link = self._group(func, args, kwargs, ns)
        self.records += [Collective(kind, tuple(t.shape), t.dtype, axis, link) for t in result]
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        if self._shadow:
            return func(*args, **kwargs)
        if any(_is_dtensor(t) for t in inputs):
            return NotImplemented          # DTensor unwraps it; its local ops come back here
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        if any(t.device.type == "meta" for t in outputs):
            return out          # shapes only (a template on `meta`): no storage, no traffic
        for t in outputs:
            self._track(t)
        if self._collective(func, args, kwargs, out):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if outputs and not func.is_view:
            self.bytes += _tensor_bytes(inputs) + _tensor_bytes(outputs)
        return out
