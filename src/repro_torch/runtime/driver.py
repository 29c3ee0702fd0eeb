"""Fault-tolerant training driver.

Counterpart of ``repro/runtime/driver.py``.  The driver owns the loop the
launcher runs: batches → train_step → metrics, with

- **checkpoint/restart**: async checkpoints every N steps, in the
  reference's layout (``models.params.to_jax_state``); on any step
  failure the driver waits for a checkpoint still being written, restores
  the latest one with the bundle's shardings into the live state and
  replays from there (the data pipeline is seeded per (step, rank), so
  replay is exact);
- **elastic rescale**: ``rescale(new_bundle, state)`` places the state's
  full values on the new bundle's mesh and shardings: losing a pod
  shrinks (pod, data, model) -> (data, model) without losing progress;
- **straggler detection**: per-step wall times feed an online P95
  estimate; steps exceeding ``straggler_factor × P95`` are recorded;
- **fault injection** for tests through ``inject_failure``.

On a mesh every rank runs the loop on the same batches (the step takes
its rows); every rank gathers a checkpoint's full values, rank 0 writes
them, and the ranks meet before they read one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import axis_groups
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.params import from_jax_state, to_jax_state
from repro_torch.train.steps import (
    StepBundle, full_state, load_state, place_state,
)


@dataclass
class TrainReport:
    steps_run: int = 0
    restarts: int = 0
    rescales: int = 0
    losses: list = field(default_factory=list)
    straggler_steps: list = field(default_factory=list)
    events: list = field(default_factory=list)


class ElasticTrainer:
    def __init__(self, bundle: StepBundle, batches: Callable[[int], dict],
                 *, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 straggler_factor: float = 3.0,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.bundle = bundle
        self.batches = batches          # step -> batch dict of tensors
        self.ckpt = (CheckpointManager(ckpt_dir) if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.log_every = log_every
        self.log = log_fn
        self.report = TrainReport()
        self._fail_at: Optional[int] = None
        self._step_fn = None
        self._compile()

    def _compile(self):
        self._step_fn = self.bundle.step_fn

    # --- fault injection (tests/examples) ---------------------------------

    def inject_failure(self, at_step: int) -> None:
        self._fail_at = at_step

    # --- elastic ------------------------------------------------------------

    def rescale(self, new_bundle: StepBundle, state) -> Any:
        """Re-place ``state`` onto ``new_bundle``'s mesh (e.g. after losing
        a pod).  Every rank of the old mesh calls it; a rank outside the
        new mesh gets None."""
        self.bundle = new_bundle
        self._compile()
        self.report.rescales += 1
        if new_bundle.mesh is None or new_bundle.in_shardings is None:
            return state
        state = place_state(new_bundle.cfg, full_state(state),
                            new_bundle.in_shardings[0])
        self.report.events.append(("rescale",
                                   mesh_axis_sizes(new_bundle.mesh)))
        return state

    # --- checkpoints ------------------------------------------------------------

    def _save(self, step: int, state) -> None:
        tree = to_jax_state(self.bundle.cfg, state)
        if self.bundle.mesh is None or dist.get_rank() == 0:
            self.ckpt.save(step, tree)

    def _sync(self) -> None:
        """Wait for the checkpoint being written and, on a mesh, for every
        rank, so that all of them see the same checkpoints."""
        self.ckpt.wait()
        mesh = self.bundle.mesh
        if mesh is not None:
            token = torch.zeros(1, device=mesh.device_type)
            for group in axis_groups(mesh, mesh_axis_sizes(mesh)):
                dist.all_reduce(token, group=group)

    def _restore(self, state, template) -> int:
        """Load the latest checkpoint into ``state`` in place, placed with
        the bundle's shardings; its step."""
        cfg = self.bundle.cfg
        shardings = None
        if self.bundle.in_shardings is not None:
            shardings = to_jax_state(cfg, self.bundle.in_shardings[0])
        step, tree = self.ckpt.restore(template, shardings)
        load_state(state, from_jax_state(cfg, tree))
        return step

    # --- main loop ------------------------------------------------------------

    def run(self, state, *, steps: int, start_step: int = 0):
        step = start_step
        template = None
        if self.ckpt is not None:
            template = to_jax_state(self.bundle.cfg, state, device="meta")
            self._sync()
            if self.ckpt.latest_step() is not None:
                step = self._restore(state, template)
                self.log(f"[driver] resumed from checkpoint step {step}")
        times: list[float] = []
        while step < steps:
            batch = self.batches(step)
            try:
                if self._fail_at is not None and step == self._fail_at:
                    self._fail_at = None
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = self._step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
            except Exception as e:                       # noqa: BLE001
                self.report.events.append(("failure", step, repr(e)))
                if self.ckpt is not None:
                    # a save still being written is the latest checkpoint
                    self._sync()
                if self.ckpt is None or self.ckpt.latest_step() is None:
                    raise
                self.log(f"[driver] step {step} failed ({e}); restoring")
                step = self._restore(state, template)
                self.report.restarts += 1
                continue

            # straggler detection (online P95)
            times.append(dt)
            if len(times) > 8:
                p95 = float(np.percentile(times[-64:], 95))
                if dt > self.straggler_factor * p95 and len(times) > 16:
                    self.report.straggler_steps.append(step)
                    self.report.events.append(("straggler", step, dt, p95))

            self.report.losses.append(loss)
            self.report.steps_run += 1
            step += 1
            if step % self.log_every == 0:
                self.log(f"[driver] step {step}: loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            if self.ckpt is not None and step % self.ckpt_every == 0:
                self._save(step, state)
        if self.ckpt is not None:
            self._save(steps, state)
            self._sync()
        return state
