"""Scenario sweep subsystem: declarative grids over the emulation engine.

The paper's pitch is cheap *exploration* — a pipeline "under various
operating conditions" on one machine.  This package turns that into an
experiment-scale workflow:

- :mod:`repro_torch.sweep.grid` — :class:`SweepSpec`, a declarative parameter
  grid (axes x base) expanded into content-hashed :class:`Scenario`\\ s;
- :mod:`repro_torch.sweep.topologies` — deterministic topology generators
  (star, chain, tree, fat-tree, random geo-WAN);
- :mod:`repro_torch.sweep.scenarios` — the default params->PipelineSpec
  builder over generated topologies;
- :mod:`repro_torch.sweep.runner` — :func:`run_sweep`, a parallel runner with
  per-scenario atomic result caching (interrupted sweeps resume) on a
  warm persistent worker pool (:func:`warm_pool` / :func:`shutdown_pool`
  — forkserver-preloaded where available, spawn fallback);
- :mod:`repro_torch.sweep.results` — :class:`SweepResults`, columnar
  aggregation, summary tables and determinism fingerprints.

Quickstart::

    from repro_torch.sweep import SweepSpec, run_sweep

    sweep = SweepSpec(
        name="demo",
        axes={"n_hosts": [12, 24], "delivery": ["poll", "wakeup"]},
        base={"topology": "geo_wan", "horizon": 20.0, "seed": 0})
    results = run_sweep(sweep, workers=2, cache_dir=".sweep_cache/demo")
    print(results.table())
"""
from repro_torch.sweep.grid import Scenario, SweepSpec, builder_ref, scenario_id
from repro_torch.sweep.results import SweepResults, TIMING_KEYS
from repro_torch.sweep.runner import (
    run_sweep, shutdown_pool, warm_pool, warm_pool_pids,
)
from repro_torch.sweep.scenarios import build_scenario
from repro_torch.sweep.topologies import GENERATORS, generate, hosts_of

__all__ = [
    "SweepSpec", "Scenario", "SweepResults", "run_sweep",
    "build_scenario", "generate", "hosts_of", "GENERATORS",
    "builder_ref", "scenario_id", "TIMING_KEYS",
    "warm_pool", "shutdown_pool", "warm_pool_pids",
]
