"""Fault-tolerant training driver.

Counterpart of ``repro/runtime/driver.py``.  The driver owns the loop the
launcher runs: batches → train_step → metrics, with

- **checkpoint/restart**: async checkpoints every N steps, in the
  reference's layout (``models.params.to_jax_state``); on any step
  failure the driver waits for a checkpoint still being written, restores
  the latest one into the live state and replays from there (the data
  pipeline is seeded per (step, rank), so replay is exact);
- **straggler detection**: per-step wall times feed an online P95
  estimate; steps exceeding ``straggler_factor × P95`` are recorded;
- **fault injection** for tests through ``inject_failure``.

``rescale`` keeps the reference's single-device behaviour (it swaps the
bundle and counts the rescale); resharding onto a mesh waits for ROADMAP
A11.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import from_jax_state, to_jax_state
from repro_torch.train.steps import StepBundle, load_state


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
        if new_bundle.mesh is not None:
            raise NotImplementedError("rescaling onto a mesh is not ported "
                                      "to repro_torch yet (ROADMAP A11)")
        self.bundle = new_bundle
        self._compile()
        self.report.rescales += 1
        return state

    # --- checkpoints ------------------------------------------------------------

    def _save(self, step: int, state) -> None:
        self.ckpt.save(step, to_jax_state(self.bundle.cfg, state))

    def _restore(self, state, template) -> int:
        """Load the latest checkpoint into ``state`` in place; its step."""
        step, tree = self.ckpt.restore(template)
        load_state(state, from_jax_state(self.bundle.cfg, tree))
        return step

    # --- main loop ------------------------------------------------------------

    def run(self, state, *, steps: int, start_step: int = 0):
        step = start_step
        template = None
        if self.ckpt is not None:
            template = to_jax_state(self.bundle.cfg, state, device="meta")
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
                    self.ckpt.wait()
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
            self.ckpt.wait()
        return state
