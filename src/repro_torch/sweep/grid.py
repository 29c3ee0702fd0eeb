"""Declarative sweep grids: axes x base params -> concrete scenarios.

A :class:`SweepSpec` names a parameter grid (the cartesian product of
``axes``, laid over ``base`` defaults) and a *builder* — a module-level
callable mapping one resolved params dict to a
:class:`~repro_torch.core.spec.PipelineSpec`.  Expansion is eager and cheap;
each grid point becomes a :class:`Scenario` with a stable content-hash
id over ``(builder reference, params)``, which is what the runner's
resume cache keys on: change any knob (or swap in a differently-named
builder) and the scenario reruns, leave it untouched and the cached
result is reused.  Only the builder's *import path* is hashed, not its
code — after editing builder or engine internals, clear the cache dir
(or pass ``force=True`` to the runner) to avoid reusing stale results.

Axes are plain param names resolved by the builder — the default
:func:`~repro_torch.sweep.scenarios.build_scenario` understands the partition
family (``partitions``, ``consumer_groups``, ``linger_ms``, ``n_keys``)
and the event-time/operator family (``windowed``, ``window_s``,
``time_mode``, ``allowed_lateness``, ``checkpoint_interval``,
``spe_semantics``, ``et_jitter_s``, ``fault="spe_down"``) alongside the
earlier topology/broker/fault knobs, and every axis value is part of
the scenario content hash, so the resume cache and the cross-process
fingerprint contract extend to the windowed grids unchanged — the new
``late_records`` / ``windows_fired`` / ``checkpoint_count`` /
``recovered_duplicates`` metrics are deterministic and fingerprinted.

Builders must be importable module-level functions (the parallel runner
ships them to spawn-based worker processes by reference).  The optional
``derive`` hook rewrites each params dict at expansion time — in the
parent, *before* hashing — for values that are functions of several axes
(e.g. ``seed = 1000 * rep + delay_ms`` in the Fig. 8 sweep).
"""
from __future__ import annotations

import copy
import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.sweep.scenarios import build_scenario


def builder_ref(fn: Callable) -> str:
    """Stable textual reference of a module-level builder."""
    return f"{fn.__module__}:{fn.__qualname__}"


def scenario_id(params: dict, builder: Callable) -> str:
    """Content hash of one grid point (the resume-cache key)."""
    blob = json.dumps({"builder": builder_ref(builder), "params": params},
                      sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass(eq=False)
class Scenario:
    """One concrete grid point: resolved params + how to build it."""

    sweep: str
    params: dict
    builder: Callable
    repeats: int = 1

    @property
    def id(self) -> str:
        return scenario_id(self.params, self.builder)

    def build(self):
        return self.builder(self.params)


@dataclass
class SweepSpec:
    """A declarative scenario grid.

    ``axes`` maps param name -> value list (product order follows axes
    insertion order, values in given order); ``base`` holds fixed params
    (``horizon`` and ``seed`` are read by the runner).  ``repeats`` > 1
    re-runs each scenario in-worker keeping the best wall time — the
    deterministic metrics are identical across repeats by construction.
    """

    name: str
    axes: dict[str, Sequence]
    base: dict = field(default_factory=dict)
    builder: Callable = build_scenario
    derive: Optional[Callable[[dict], Optional[dict]]] = None
    repeats: int = 1

    def __len__(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def scenarios(self) -> list[Scenario]:
        names = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[k] for k in names)):
            # deep copy per grid point: nested values (topo, broker_cfg)
            # must not alias across scenarios or the caller's base — a
            # derive hook mutating one would corrupt the others' hashes
            params = copy.deepcopy({**self.base, **dict(zip(names, combo))})
            if self.derive is not None:
                params = self.derive(params) or params
            out.append(Scenario(self.name, params, self.builder,
                                self.repeats))
        return out
