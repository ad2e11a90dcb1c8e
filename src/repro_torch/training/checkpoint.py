"""Checkpointing with atomic commits and async writes.

Counterpart of ``repro/training/checkpoint.py``, with its layout::

    <root>/step_<N>/
        arrays.npz           flattened pytree leaves, path-keyed
        manifest.json        step, shapes/dtypes, extra

Keys are the reference's path keys (``params/runs/0/mix/wq``,
``opt/m/...``, ``opt/step``) and manifest dtypes are numpy's names, so a
float32/int32 checkpoint is read by either package. A bfloat16 leaf is
stored as its 16-bit patterns (``uint16``) with ``"bfloat16"`` in the
manifest and restored bit for bit; the reference writes numpy's 2-byte
void type there, which the port also reads back as bfloat16.

Guarantees:
- atomic: a checkpoint directory appears only after a full write
  (tmp dir + ``os.replace``); a crash mid-write leaves no partial step;
- async: ``save(..., blocking=False)`` copies every leaf to host memory
  first, then hands the copies to a writer thread: a step that updates
  the tensors in place afterwards cannot tear the checkpoint;
- sharded: a tree with DTensor leaves is saved whole. Every rank joins
  each leaf's gather, rank 0 writes, and every rank waits at a barrier
  (in :meth:`CheckpointManager.wait`) until the write is done; the
  manifest is the same as an unsharded save's;
- restorable onto any mesh: ``restore(like, step, shardings)`` with a
  matching tree of :class:`~repro_torch.distributed.sharding.NamedSharding`
  has every rank read the arrays and keep only its own slice of each
  leaf, as a DTensor of the layout asked for (no collective). Restoring
  onto another mesh shape is the elastic re-mesh path
  (:func:`repro_torch.training.ft.elastic_plan`).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as pytree
from repro_torch.distributed import layout
from repro_torch.distributed.sharding import NamedSharding


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(host copies by path key, dtype names by path key); a DTensor leaf
    is gathered whole first (a collective: every rank calls this)."""
    flat, dtypes = {}, {}
    for path, leaf in pytree.leaves_with_path(tree):
        key = pytree.path_key(path)
        flat[key], dtypes[key] = pytree.to_numpy(layout.whole(leaf))
    return flat, dtypes


def _structure(tree: Any, is_leaf) -> Any:
    """The nesting of ``tree`` with every leaf replaced by None."""
    if is_leaf(tree):
        return None
    if isinstance(tree, dict):
        return {k: _structure(v, is_leaf) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_structure(v, is_leaf) for v in tree]
    return None


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        self._barrier = False     # a sharded save's ranks still to meet

    # ------------------------------------------------------------------ io
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        sharded = any(layout.is_sharded(t) for t in pytree.leaves(tree))
        flat, dtypes = _flatten(tree)  # copies to host
        meta = {
            "step": step,
            "saved_at": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
            "extra": extra or {},
        }
        self.wait()
        if sharded and dist.get_rank() != 0:
            pass                      # rank 0 writes; this rank waits below
        elif blocking:
            self._write(step, flat, meta)
        else:
            self._writer = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._writer.start()
        self._barrier = sharded
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Wait for the last save's write; after a sharded save, every
        rank waits here until rank 0 has written."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: Dict):
        tmp = Path(tempfile.mkdtemp(dir=self.root, prefix=".tmp_"))
        try:
            np.savez(tmp / "arrays.npz", **flat)
            with open(tmp / "manifest.json", "w") as f:
                json.dump(meta, f, indent=2)
            final = self.root / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------------- read
    def steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            if p.name.startswith("step_") and (p / "manifest.json").exists():
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like`` (a pytree of tensors):
        each leaf takes the dtype and the device of ``like``'s leaf.
        ``shardings``: an optional matching pytree of ``NamedSharding``;
        each leaf then comes back as a DTensor of that layout on the
        mesh's device, this rank keeping only its slice (the elastic
        re-mesh path)."""
        if shardings is not None:
            is_ns = lambda t: isinstance(t, NamedSharding)
            if _structure(shardings, is_ns) != _structure(
                    like, lambda t: not isinstance(t, (dict, list, tuple))):
                raise ValueError("shardings do not match the structure of "
                                 "like")
            shard_leaves = pytree.leaves(shardings)
            if not all(is_ns(s) for s in shard_leaves):
                raise TypeError("shardings must be NamedSharding leaves")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        dtypes = {k: v["dtype"] for k, v in self.manifest(step)[
            "leaves"].items()}
        with np.load(d / "arrays.npz", allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        leaves = []
        for i, (path, leaf) in enumerate(pytree.leaves_with_path(like)):
            key = pytree.path_key(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = flat.pop(key)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != "
                    f"{tuple(leaf.shape)}")
            if shardings is None:
                t = pytree.from_numpy(arr, leaf.device, dtypes.get(key))
                leaves.append(t.to(leaf.dtype))
                continue
            sh = shard_leaves[i]
            whole = pytree.from_numpy(arr, "cpu", dtypes.get(key)).to(
                leaf.dtype)
            # this rank's slice only, cut on the host: no collective
            mine = layout.own_slice(whole, sh.mesh, sh.placements)
            leaves.append(DTensor.from_local(
                mine.contiguous().to(sh.mesh.device_type), sh.mesh,
                sh.placements,
                run_check=False, shape=whole.shape, stride=whole.stride()))
        return pytree.unflatten(like, leaves)

    def manifest(self, step: int) -> Dict:
        with open(self.root / f"step_{step:08d}" / "manifest.json") as f:
            return json.load(f)
