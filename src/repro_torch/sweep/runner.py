"""Parallel, resumable sweep runner with warm persistent workers.

Fans a :class:`~repro_torch.sweep.grid.SweepSpec`'s scenarios across worker
processes and aggregates the structured per-run metrics
(:meth:`Engine.run_metrics`) into a :class:`~repro_torch.sweep.results.
SweepResults` table.

Resume contract: with ``cache_dir`` set, every *completed* scenario is
written to ``<cache_dir>/<scenario_id>.json`` atomically (tmp file +
``os.replace``) by the worker that ran it — so an interrupted sweep
(crash, SIGTERM, power loss) leaves only whole result files behind, and
the rerun loads them instead of recomputing.  The scenario id is a
content hash over (builder, params): edit any knob and only the touched
grid points rerun.  Torn or stale files fail validation and simply
rerun — including files whose **params did not survive the JSON round
trip**: rows are serialized with ``default=repr``, so a non-JSON-native
param (a tuple, a set, a custom object) silently reloads as a different
value; :func:`_load_cached` compares the loaded params against the live
grid's params and discards the row on any mismatch instead of serving
it.

Warm workers: grid-scale experimentation runs *many* sweeps back to
back, and a worker process costs a full interpreter + numpy import
(~0.5 s) when spawned cold.  :func:`warm_pool` keeps **one persistent
pool per process** that is reused across :func:`run_sweep` calls, built
on the ``forkserver`` start method where available: the fork server
preloads ``repro_torch.sweep.runner`` (numpy + the engine stack, **never
torch**, and never JAX or ``repro`` — SPE queries import torch lazily
inside the worker, keeping forked children safe), so new workers fork
from a warm template instead of re-importing the world.  Platforms
without ``forkserver`` fall back to ``spawn`` — the pool is still
persistent, so only the first sweep pays the imports.  Builders must be importable module-level functions either
way (workers unpickle them by reference), and scripts that call
:func:`run_sweep` with ``workers > 1`` still want the usual
``if __name__ == "__main__":`` guard for the spawn fallback.
``workers <= 1`` runs inline in this process (no pickling constraints —
handy for tests and debugging).

Repeats contract: ``repeats > 1`` keeps the best wall time and
**asserts** every deterministic metric is identical across the repeats
— a cheap standing guard for the cross-process determinism contract
(the cache mixes rows from different workers; a scenario whose metrics
drift between runs would poison it silently).
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
from typing import Callable, Optional

from repro_torch.core.engine import Engine
from repro_torch.sweep.grid import Scenario, SweepSpec, scenario_id
from repro_torch.sweep.results import TIMING_KEYS, SweepResults

# (scenario_id, params, builder, repeats, cache_path | None)
_Task = tuple

# modules preloaded into the fork server: the engine stack + numpy.
# torch must never appear here (lazy-imported by SPE queries only) —
# forking a process with initialized CUDA state is unsafe.
_PRELOAD = ["repro_torch.sweep.runner"]


def _run_one(task: _Task) -> dict:
    """Build + run one scenario; persist its row if caching is on."""
    sid, params, builder, repeats, cache_path = task
    metrics = None
    for _ in range(max(1, int(repeats))):
        eng = Engine(builder(params), seed=int(params.get("seed", 0)))
        m = eng.run_metrics(until=float(params.get("horizon", 30.0)))
        if metrics is None:
            metrics = m
            continue
        # the determinism contract, enforced: every field except the
        # wall clock must reproduce exactly within one process too
        diverged = [k for k in metrics
                    if k not in TIMING_KEYS and metrics[k] != m[k]]
        if diverged:
            raise AssertionError(
                f"scenario {sid}: nondeterministic metrics across "
                f"repeats: {diverged[:5]} "
                f"(e.g. {diverged[0]}: {metrics[diverged[0]]!r} != "
                f"{m[diverged[0]]!r})")
        if m["wall_s"] < metrics["wall_s"]:
            # keep the best wall time (benchmarks run on loaded hosts)
            metrics["wall_s"] = m["wall_s"]
    row = {"scenario_id": sid, "params": params, "metrics": metrics,
           "cached": False}
    if cache_path:
        tmp = f"{cache_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            # default=repr mirrors the content hash: a non-JSON-native
            # param must not crash the write after the run completed
            # (the reload-side hash check catches the lossy round trip)
            json.dump(row, f, default=repr)
        os.replace(tmp, cache_path)
    return row


def _load_cached(path: str, scenario: Scenario) -> Optional[dict]:
    """Load one cached row; None if torn, stale, or round-trip-lossy.

    The round-trip guard: rows are written with ``default=repr``, so
    params JSON cannot represent faithfully (tuples become lists, sets
    and objects become repr strings) reload as *different values* —
    and because the content hash itself is computed through the same
    ``default=repr`` encoding, the degraded params can still hash to
    the scenario's id and silently impersonate the original.  The only
    faithful check is direct equality against the live grid's params
    (available right here), so that is what gates: mismatching rows
    rerun instead of poisoning aggregation with repr-strings.  The id
    recompute on top catches files copied across scenario slots.
    """
    try:
        with open(path) as f:
            row = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(row, dict) or "metrics" not in row \
            or "params" not in row or not row.get("scenario_id"):
        return None
    if row["params"] != scenario.params \
            or scenario_id(row["params"], scenario.builder) != scenario.id:
        return None                       # lossy round trip / stale file
    row["cached"] = True
    return row


# ---------------------------------------------------------------------------
# Warm persistent worker pool
# ---------------------------------------------------------------------------

_warm_pool = None          # (pool, n_workers, method)


def _pick_method(requested: Optional[str]) -> str:
    if requested:
        return requested
    methods = mp.get_all_start_methods()
    return "forkserver" if "forkserver" in methods else "spawn"


def warm_pool(workers: int, mp_context: Optional[str] = None):
    """The process-wide persistent worker pool (created on first use).

    Reused across :func:`run_sweep` calls so repeated sweeps skip the
    per-worker interpreter + numpy import.  Sized *exactly* to
    ``workers`` — a wider live pool would silently run more scenarios
    concurrently than the caller's cap allows (memory-heavy grids set
    ``workers`` deliberately), so a size or start-method change
    recreates the pool; under forkserver the replacement workers fork
    from the warm preloaded template, which keeps resizing cheap.
    """
    global _warm_pool
    method = _pick_method(mp_context)
    if _warm_pool is not None:
        pool, n, live_method = _warm_pool
        if n == workers and live_method == method:
            return pool
        shutdown_pool()
    ctx = mp.get_context(method)
    if method == "forkserver":
        # lazy-torch guard: preload the engine stack (numpy included)
        # into the fork server template; torch stays un-imported there,
        # so forked workers start warm *and* torch-clean
        ctx.set_forkserver_preload(_PRELOAD)
    pool = ctx.Pool(workers)
    _warm_pool = (pool, workers, method)
    return pool


def shutdown_pool() -> None:
    """Tear down the persistent pool (tests / interpreter shutdown)."""
    global _warm_pool
    if _warm_pool is not None:
        pool, _, _ = _warm_pool
        _warm_pool = None
        pool.terminate()
        pool.join()


def warm_pool_pids() -> list[int]:
    """Worker pids of the live persistent pool (``[]`` when none).

    The public surface for warm-reuse assertions (CI smoke, tests) —
    keeps knowledge of ``multiprocessing.Pool`` internals in this one
    place."""
    if _warm_pool is None:
        return []
    pool, _, _ = _warm_pool
    return sorted(w.pid for w in pool._pool)


def _worker_probe(_=None) -> dict:
    """Worker introspection for tests: pid + whether torch, JAX or the
    JAX package ``repro`` was imported."""
    roots = {m.split(".")[0] for m in sys.modules}
    return {"pid": os.getpid(), "torch_loaded": "torch" in roots,
            "jax_loaded": "jax" in roots, "repro_loaded": "repro" in roots}


def run_sweep(sweep: SweepSpec, *, workers: int = 2,
              cache_dir: Optional[str] = None, force: bool = False,
              mp_context: Optional[str] = None, warm: bool = True,
              select: Optional[Callable[[Scenario], bool]] = None,
              progress: Optional[Callable[[str], None]] = None
              ) -> SweepResults:
    """Run (or resume) a sweep; returns rows in grid order.

    ``cache_dir=None`` disables caching (every scenario runs).  ``force``
    ignores — but still rewrites — existing cache entries.  ``select``
    filters scenarios (partial sweeps share the same cache keys, so a
    later full run reuses their results).  ``warm=True`` (default) runs
    on the persistent :func:`warm_pool`; ``warm=False`` builds a
    throwaway pool per call (the pre-warm behavior).  ``mp_context``
    picks the start method explicitly (default: ``forkserver`` when the
    platform has it, else ``spawn``).
    """
    scens = sweep.scenarios()
    if select is not None:
        scens = [s for s in scens if select(s)]
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    rows: dict[str, dict] = {}
    pending: list[_Task] = []
    for s in scens:
        path = os.path.join(cache_dir, f"{s.id}.json") if cache_dir else None
        row = None if (force or path is None) else _load_cached(path, s)
        if row is not None:
            rows[s.id] = row
        else:
            pending.append((s.id, s.params, s.builder, s.repeats, path))
    if progress:
        progress(f"sweep {sweep.name!r}: {len(scens)} scenarios "
                 f"({len(rows)} cached, {len(pending)} to run, "
                 f"workers={workers})")
    if pending:
        if workers <= 1 or len(pending) == 1:
            for t in pending:
                rows[t[0]] = _run_one(t)
                if progress:
                    progress(f"  ran {t[0]}")
        elif warm:
            pool = warm_pool(workers, mp_context)
            try:
                for row in pool.imap_unordered(_run_one, pending):
                    rows[row["scenario_id"]] = row
                    if progress:
                        progress(f"  ran {row['scenario_id']}")
            except BaseException:
                # Ctrl-C / a failing scenario: abandoned tasks would
                # keep running invisibly on the persistent workers and
                # the next sweep would queue behind them — tear the
                # pool down so interrupt-and-rerun stays cheap (rows
                # already cache-written by workers survive and resume)
                shutdown_pool()
                raise
        else:
            ctx = mp.get_context(_pick_method(mp_context))
            with ctx.Pool(min(workers, len(pending))) as pool:
                for row in pool.imap_unordered(_run_one, pending):
                    rows[row["scenario_id"]] = row
                    if progress:
                        progress(f"  ran {row['scenario_id']}")
    return SweepResults([rows[s.id] for s in scens], name=sweep.name)
