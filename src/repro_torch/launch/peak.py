"""Split a dry-run cell's peak of live storage by tensor.

    python -m repro_torch.launch.peak --arch deepseek-v3-671b --shape train_4k \\
        --mesh single --reps 1 [--device cuda] [--top 25]

Runs the cell's step as the dry run traces it (``dryrun.build_step`` at
``--reps`` repetitions, cut as ``dryrun.calibrate`` cuts the depth, and
``dryrun.count_step``), on rank 0 of a fake world, under :class:`PeakSplit`: a ``StepCounter`` that also
records, for every storage of at least ``min_bytes``, its shape, dtype, the
op that made it and the ``repro_torch`` frames that called the op, counts
the storages made of each shape, and keeps the live storages whenever the
peak grows.  Prints the peak, the storage
tracked before the step (params, optimizer state, inputs), and the largest
storages live at the peak with their sums by op and caller.  As for the dry
run, the counts come from the card machine (a CPU-only torch runs no
autograd on fake ``cuda`` tensors).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import traceback


from repro_torch.launch import roofline as rf


def _caller() -> str:
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "launch/" not in f.filename]
    return " < ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                      for f in frames[-4:][::-1])


class PeakSplit(rf.StepCounter):
    """A ``StepCounter`` that names the storages live at its peak."""

    def __init__(self, mesh=None, min_bytes: int = 32 << 20, step_bytes: int = 64 << 20):
        super().__init__(mesh)
        self.min_bytes, self.step_bytes = min_bytes, step_bytes
        self.made = {}                 # storage id -> (shape, dtype, op, caller) or None
        self.shapes = collections.Counter()   # (shape, dtype) -> storages made
        self.at_peak = (0, [])         # (peak bytes, [(bytes, made entry)] live then)
        self._op = "tracked before the step"
        self.tracked = 0               # live bytes once the step's arguments are tracked

    def track(self, *trees):
        super().track(*trees)
        self.tracked = self.live_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer, self._op = self._op, str(func)
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._op = outer

    def _track(self, t):
        st = t.untyped_storage()
        key, before = id(st), self.peak_bytes
        new = key not in self._live
        super()._track(t)
        if new:
            self.made[key] = None
            if st.nbytes() >= self.min_bytes:
                shape = (tuple(t.shape), str(t.dtype)[6:])
                self.made[key] = (*shape, self._op, _caller())
                self.shapes[shape] += 1
        if self.peak_bytes > before and self.peak_bytes - self.at_peak[0] > self.step_bytes:
            self.at_peak = (self.peak_bytes,
                            [(n, self.made.get(k)) for k, (_, n) in self._live.items()])

    def report(self, top: int = 25) -> str:
        peak, live = self.at_peak
        big = sorted(((n, m) for n, m in live if m is not None), key=lambda x: -x[0])
        by_op = collections.defaultdict(lambda: [0, 0])
        for n, (_, _, op, caller) in big:
            by_op[op, caller][0] += n
            by_op[op, caller][1] += 1
        lines = [f"peak {self.peak_bytes / 1e9:.3f} GB (kept at {peak / 1e9:.3f}); "
                 f"{len(live)} storages live, {sum(n for n, m in live if m is None) / 1e9:.3f} GB "
                 f"of them under {self.min_bytes >> 20} MB", "by op and caller (GB, count):"]
        lines += [f"{n / 1e9:9.3f} {c:4d}  {op} @ {caller}"
                  for (op, caller), (n, c) in sorted(by_op.items(), key=lambda x: -x[1][0])[:top]]
        lines.append("largest:")
        lines += [f"{n / 1e9:9.3f}  {shape} {dtype} {op} @ {caller}"
                  for n, (shape, dtype, op, caller) in big[:top]]
        return "\n".join(lines)


def main(argv=None):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    full = get_config(args.arch)
    cfg = dataclasses.replace(dryrun.reduced_cfg(full, args.reps), q_chunk=full.q_chunk,
                              mlstm_chunk=full.mlstm_chunk)
    with dryrun.fake_world(math.prod(PRODUCTION_MESHES[multi][1])):
        mesh = make_production_mesh(multi_pod=multi, device=args.device)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, step_args = dryrun.build_step(cfg, SHAPES_BY_NAME[args.shape], mesh, args.arch,
                                                device=args.device)
            split = dryrun.count_step(step, step_args, mesh, counter=PeakSplit(mesh))
    print(f"{args.arch} {args.shape} {dryrun._mesh_name(multi)} at {args.reps} repetitions: "
          f"tracked before the step {split.tracked / 1e9:.3f} GB")
    print(split.report(args.top))
    return split


if __name__ == "__main__":
    main()
