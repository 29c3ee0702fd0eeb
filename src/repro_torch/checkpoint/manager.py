"""Async, atomic, integrity-checked checkpoints in the reference's layout.

Counterpart of ``repro/checkpoint/manager.py``, writing the same files:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json``.  A tree of nested
dicts and lists is flattened to keys that join the path with ``/`` (dict
keys sorted, as JAX flattens them); bfloat16 leaves are stored as uint16
with a ``"bfloat16"`` tag; each leaf carries the CRC32 of its stored
bytes.  Writes go to ``step_<N>.tmp`` and are renamed, so a crash
mid-save never corrupts the latest checkpoint.  ``CheckpointManager.save``
snapshots the tree to host memory, then writes on a background thread.

So a checkpoint of either package restores into the other; the train
state is turned into the reference's tree (groups stacked) by
``models.params.to_jax_state`` and back by ``from_jax_state``.  Restoring
onto a mesh (the reference's ``shardings``) waits for ROADMAP A11.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


def _host(leaf):
    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf


def _stored(leaf) -> tuple[np.ndarray, str]:
    """(the array written to the npz, its dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_tree(tree, step_dir: str) -> None:
    """Synchronous write of a tree of tensors or numpy arrays."""
    tmp = step_dir + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"leaves": {}}
    for key, leaf in _flatten(tree).items():
        stored, dtype_name = _stored(leaf)
        arrays[key] = stored
        manifest["leaves"][key] = {
            "shape": list(stored.shape),
            "dtype": dtype_name,
            "crc": zlib.crc32(np.ascontiguousarray(stored).tobytes()),
        }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp, step_dir)


def restore_tree(step_dir: str, template):
    """Restore into ``template``'s tree structure (only its keys are read)
    as tensors on the CPU; raises IOError on a CRC mismatch."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for key in _flatten(template):
            meta = manifest["leaves"][key]
            stored = data[key]
            if zlib.crc32(np.ascontiguousarray(stored).tobytes()) \
                    != meta["crc"]:
                raise IOError(f"checkpoint leaf {key}: CRC mismatch")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(stored.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(stored.copy())
            flat[key] = t.reshape(meta["shape"])
    return _unflatten(template, flat)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree) -> None:
        """Async save: snapshot to host now, write in the background.

        Host leaves are taken as they are (the reference's ``np.asarray``):
        a caller that goes on mutating them passes copies."""
        self.wait()
        host_tree = _unflatten(tree, {k: _host(v) for k, v in
                                      _flatten(tree).items()})

        def _write():
            save_tree(host_tree, self._step_dir(step))
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def restore(self, template, step: Optional[int] = None):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, restore_tree(self._step_dir(step), template)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
