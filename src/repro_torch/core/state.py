"""Checkpoint state backends for SPE operator recovery.

A backend is the *durable* side of the checkpoint protocol: it lives
outside the emulated host (the job-manager / remote object-store role),
so a ``host_down`` fault wipes the runtime's volatile operator state but
never the snapshots.  The runtime writes one snapshot per checkpoint —
``{"chain": [...op states...], "query": {...}, "proc_off": {...},
"maxet": {...}, "buffer": [...], "epoch": n}`` — and recovery restores
the latest one and seeks the committed input offsets back to
``proc_off`` (see ``core/spe.py``).

Two implementations:

- :class:`MemoryStateBackend` (default): per-engine in-process store;
  snapshots are deep-copied on both ``put`` and ``latest`` so a restored
  runtime can never alias (and mutate) the durable copy.
- :class:`FileStateBackend`: pickles each snapshot under
  ``<dir>/<name>.ckpt`` with the same atomic ``tmp + os.replace``
  pattern as the sweep runner's result cache — a kill at any point
  leaves either the previous whole snapshot or the new whole snapshot,
  never a torn file.
"""
from __future__ import annotations

import copy
import os
import pickle
from typing import Any, Optional


class StateBackend:
    """Interface: durable keyed snapshot store."""

    def put(self, name: str, snapshot: dict) -> None:
        raise NotImplementedError

    def latest(self, name: str) -> Optional[dict]:
        raise NotImplementedError


class MemoryStateBackend(StateBackend):
    """In-process durable store (survives emulated host failures)."""

    def __init__(self) -> None:
        self._snaps: dict[str, dict] = {}

    def put(self, name: str, snapshot: dict) -> None:
        self._snaps[name] = copy.deepcopy(snapshot)

    def latest(self, name: str) -> Optional[dict]:
        snap = self._snaps.get(name)
        return copy.deepcopy(snap) if snap is not None else None


class FileStateBackend(StateBackend):
    """Pickled snapshots on disk, written atomically (tmp + replace)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in name)
        return os.path.join(self.directory, f"{safe}.ckpt")

    def put(self, name: str, snapshot: dict) -> None:
        path = self._path(name)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(snapshot, f)
        os.replace(tmp, path)

    def latest(self, name: str) -> Optional[dict]:
        # unpickling a torn/corrupt snapshot can raise nearly anything
        # (ValueError, AttributeError, ImportError, ...); recovery must
        # degrade to a cold restart, never crash
        try:
            with open(self._path(name), "rb") as f:
                return pickle.load(f)
        except Exception:
            return None


def make_backend(cfg: Any) -> StateBackend:
    """``cfg``: None -> fresh memory backend; str -> file backend dir;
    an existing backend passes through (shared-engine default)."""
    if cfg is None:
        return MemoryStateBackend()
    if isinstance(cfg, StateBackend):
        return cfg
    return FileStateBackend(str(cfg))
