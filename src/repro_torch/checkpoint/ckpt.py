"""Async, atomic checkpointing in the reference's on-disk form.

Layout:  <dir>/step_<N>/shard_0.npz  +  manifest.json (written LAST -- its
presence marks the checkpoint committed; partial checkpoints are ignored and
garbage-collected).  The manifest records the logical shapes and dtypes.

The arrays are keyed as the reference keys them, by the ``keystr`` of each
leaf of its tree: ``[0]['blocks'][0]['attn']['wq']``, ``[1].master['embed']``
and ``[1].step`` for ``(params, OptState)``.  A model (or a dict of tensors
by parameter name, such as ``OptState``'s ``master``, ``m`` and ``v``) is
saved in the reference's layout: a ``blocks`` leaf stacked over its
repetitions, an ``enc_blocks`` / ``dec_blocks`` leaf over its layers
(``convert.reference_leaves``), bf16 stored as float32.  So each package
restores the other's checkpoint.

Async: ``save()`` snapshots to host memory synchronously and writes to disk
on a background thread, overlapping I/O with the next training steps.
``restore`` copies the arrays into the template's tensors, in place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import convert


def _host(t) -> np.ndarray:
    """A leaf as the array stored: bf16 as float32 (npz cannot round-trip ml_dtypes)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _is_named(node) -> bool:
    """A model, or a dict of tensors by parameter name."""
    return isinstance(node, torch.nn.Module) or (
        isinstance(node, dict) and node and all(isinstance(v, torch.Tensor) for v in node.values()))


def _walk(node, prefix: str):
    """The reference's flatten of ``node``: ``(keystr, leaf)`` in its order,
    a leaf being a tensor, or for a named dict the ``(rep, tensor)`` members
    of one reference leaf."""
    if _is_named(node):
        named = dict(node.named_parameters()) if isinstance(node, torch.nn.Module) else node
        for key, members in convert.reference_leaves(named):
            yield prefix + key, [(rep, named[name]) for rep, name in members]
    elif isinstance(node, tuple) and hasattr(node, "_fields"):     # a NamedTuple
        for field in node._fields:
            yield from _walk(getattr(node, field), f"{prefix}.{field}")
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from _walk(child, f"{prefix}[{i}]")
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, node


def _stacked(members) -> bool:
    return members[0][0] is not None


def _flatten(tree) -> dict:
    out = {}
    for key, leaf in _walk(tree, ""):
        if isinstance(leaf, list):
            if _stacked(leaf):
                first = _host(leaf[0][1])
                arr = np.empty((len(leaf),) + first.shape, first.dtype)
                arr[0] = first
                for i, (_, t) in enumerate(leaf[1:], 1):
                    arr[i] = _host(t)
            else:
                arr = _host(leaf[0][1])
        else:
            arr = _host(leaf)
        out[key] = arr
    return out


def _check(leaves, key, shape):
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key}")
    stored = tuple(leaves[key][0])
    if stored != tuple(shape):
        raise ValueError(f"checkpoint leaf {key} shape {stored} != expected {tuple(shape)}")


def _targets(template):
    """``(keystr, [(rep, tensor), ...])`` for each leaf of ``template``: the
    tensors a stored array is copied into (``rep`` None for the whole array,
    else the index of its repetition or layer)."""
    out = []
    for key, leaf in _walk(template, ""):
        if not isinstance(leaf, list):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"{key}: restore copies into tensors, not {type(leaf).__name__}")
            leaf = [(None, leaf)]
        out.append((key, leaf))
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False, extra: dict | None = None):
        """Snapshot ``tree`` at ``step``; disk write happens asynchronously."""
        self.wait()  # one outstanding async save at a time
        host_arrays = _flatten(tree)          # device->host copy (synchronous)
        meta = {
            "step": step,
            "time": time.time(),
            "leaves": {k: [list(v.shape), str(v.dtype)] for k, v in host_arrays.items()},
            "extra": extra or {},
        }

        def write():
            tmp = os.path.join(self.directory, f"_tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"), **host_arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)             # atomic commit
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
        # remove aborted partials
        for name in os.listdir(self.directory):
            if name.startswith("_tmp_step_"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def available_steps(self):
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                manifest = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(manifest):   # committed only
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> Tuple[int, Any]:
        """Load ``step`` (default latest) into ``template`` in place: each
        stored array is copied into the template's own tensor, on its device
        and cast to its dtype, and the template is returned.  So a restore
        holds one copy of the state (the live one, on a rewind) and a stored
        array at a time on the host.  Every leaf is checked against the
        manifest before any is written: a missing leaf raises ``KeyError``, a
        shape that differs ``ValueError``, and the template is left as it was."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        targets = _targets(template)
        for key, members in targets:
            _check(leaves, key, ((len(members),) if _stacked(members) else ())
                   + tuple(members[0][1].shape))
        with np.load(os.path.join(path, "shard_0.npz")) as z, torch.no_grad():
            for key, members in targets:
                arr = z[key]
                for rep, t in members:
                    t.copy_(torch.from_numpy(arr if rep is None else arr[rep]))
        return step, template
