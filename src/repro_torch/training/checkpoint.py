"""Fault-tolerant checkpointing: atomic commit, keep-k, async save,
checksum validation. The port of ``repro/training/checkpoint.py``, with the
reference's layout and keys, so a checkpoint goes both ways between the
packages (optimizer state included):

  <dir>/step_<N>.tmp/        staging (never read)
  <dir>/step_<N>/            committed atomically by os.rename
      arrays_p0.npz          key → array, keys as jax.tree_util.keystr
                             prints them (``['layers'][0]['w_x']``)
      meta.json              {step, checksum, extra}

A bfloat16 leaf is stored as its raw 2-byte words (numpy's ``V2``), as
the reference's are. Restore picks the newest committed step whose
checksum validates, so a half-written checkpoint is skipped, and puts the
arrays on one explicit device or, with ``shardings=``, lays each out on a
mesh.

Under a mesh (any leaf a DTensor) a save writes the full logical arrays
once: every rank gathers each leaf whole (``dist.collective_ops.
full_tensor``, a collective, so every rank calls ``save``), rank 0 writes
and commits, and the others wait for it at a barrier. ``restore(
shardings=)`` reads the whole arrays on every rank and keeps each rank's
piece of them (``dist.collective_ops.distribute``), so a run written on
one mesh resumes on another (``fault.elastic_restore``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from .tree import leaves_with_keys, unflatten

__all__ = ["CheckpointManager"]


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor,
               device) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype on ``device``."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:     # bfloat16 words
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return t.to(device=device, dtype=like.dtype)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flatten(tree) -> dict[str, np.ndarray]:
    from ..dist.collective_ops import full_tensor
    return {key: _to_numpy(full_tensor(leaf) if _is_dtensor(leaf) else leaf)
            for key, leaf in leaves_with_keys(tree)}


def _checksum(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:4096])
        h.update(str(arrays[k].shape).encode())
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None):
        """Copy ``tree``'s leaves to host arrays now, write them (in a
        thread with ``async_save``) and commit by a rename. A tree of
        DTensors is gathered whole on every rank (all must call), written
        by rank 0 alone, and the call returns on every rank once it is
        committed."""
        sharded = any(_is_dtensor(x) for _, x in leaves_with_keys(tree))
        arrays = _flatten(tree)
        meta = {"step": int(step), "checksum": _checksum(arrays),
                "extra": extra or {}}
        self.wait()
        if sharded:
            import torch.distributed as dist
            if dist.get_rank() == 0:
                self._write(step, arrays, meta)
            dist.barrier()
        elif self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, meta)

    def _write(self, step: int, arrays, meta):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays_p0.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._prune()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _read(self, step: int) -> tuple[dict, dict[str, np.ndarray]]:
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays_p0.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return meta, arrays

    def _load(self, step: int):
        """``_read(step)`` if its checksum validates, else None."""
        try:
            meta, arrays = self._read(step)
            return (meta, arrays) if meta["checksum"] == _checksum(arrays) \
                else None
        except Exception:
            return None

    def latest_step(self) -> int | None:
        for s in reversed(self.all_steps()):
            if self._load(s) is not None:
                return s
        return None

    def restore(self, template, step: int | None = None, shardings=None,
                device=None) -> tuple[Any, dict]:
        """Restore into the structure and dtypes of ``template`` (a tree of
        tensors), on ``device`` (default: where each template leaf lies).
        ``shardings``: a matching tree of ``sharding.NamedSharding`` (None
        leaves stay whole): each leaf becomes a DTensor of this rank's
        piece on its mesh (on the mesh's device), whatever mesh wrote the
        checkpoint. With ``step=None``, the newest step that validates,
        read once. Returns (tree, meta)."""
        if step is not None:
            meta, arrays = self._read(step)
        else:
            loaded = next(filter(None, map(self._load,
                                           reversed(self.all_steps()))), None)
            if loaded is None:
                raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
            meta, arrays = loaded
        pairs = leaves_with_keys(template)
        shards = ([None] * len(pairs) if shardings is None else
                  [sh for _, sh in leaves_with_keys(shardings)])
        flat = []
        for (key, leaf), sh in zip(pairs, shards):
            a = arrays.pop(key)
            if sh is not None and not hasattr(sh, "placements"):
                raise TypeError(f"{key}: a sharding is a sharding."
                                f"NamedSharding (a mesh and placements), got "
                                f"{type(sh).__name__}")
            if sh is not None:
                from ..dist.collective_ops import distribute
                t = _to_tensor(a, leaf, _mesh_device(sh.mesh))
                a = distribute(t, sh)
            elif isinstance(leaf, torch.Tensor):
                a = _to_tensor(a, leaf, (leaf.to_local().device
                                         if _is_dtensor(leaf) else
                                         leaf.device)
                               if device is None else device)
            elif hasattr(leaf, "dtype"):
                a = a.astype(leaf.dtype)
            flat.append(a)
        return unflatten(template, flat), meta


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
