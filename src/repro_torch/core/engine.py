"""Discrete-event emulation engine (the Mininet-role substrate).

The engine advances a simulated clock over a heap of scheduled events.
Components (producers, brokers, SPEs, consumers, stores) are runtime
objects instantiated from the :class:`~repro_torch.core.spec.PipelineSpec`; the
network model (``netem``) provides message timing, the broker cluster
provides event streaming, and the monitor records everything.

Functional realism: SPE nodes execute *real JAX computations* on their
windows (word counts are real counts, model logits are real logits) while
their *timing* comes from a deterministic host-compute model — emulated
hosts have ``n_cores`` and a ``cpuPercentage`` cap (Table I), and service
times queue on per-core availability.  This keeps runs reproducible on a
1-core container while preserving the paper's "same code as production"
property for outputs.

Hot-path design (large sweeps, 100+ emulated nodes):

- Events live in a **calendar queue** (:mod:`repro_torch.core.calqueue`):
  near-future timers — the dominant pattern — cost O(1)/O(log bucket)
  instead of O(log total).  Pop order is bit-identical to the legacy
  global heap (``scheduler="heap"``), which stays available for parity
  checks.
- :meth:`Engine.schedule` returns a cancellable :class:`EventHandle`;
  cancellation is *lazy* (the queue entry is skipped at pop time), so
  cancel is O(1) and no queue structure is ever re-sifted.
- ``spec.columnar`` (default True) keeps delivery **allocation-free**:
  ``Cluster.fetch`` hands subscribers zero-copy ``BatchView``s over the
  columnar logs instead of materializing per-row ``Record`` objects
  (counted in ``metrics()["record_objects_materialized"]``).
- Deterministic per-client RNG streams (:meth:`Engine.client_rng`)
  decouple independent components: a consumer drawing loss samples on its
  fetch path cannot perturb a producer's schedule.  This is what makes
  the polling and wakeup delivery modes bit-comparable on the
  produce/protocol side for a fixed seed.
- ``spec.delivery`` selects the subscriber delivery mode: ``"wakeup"``
  (default — the cluster notifies subscribers when the high watermark
  passes their offset; idle subscribers cost zero events) or ``"poll"``
  (the legacy fixed-interval path, kept for parity checks).
"""
from __future__ import annotations

import gc
import random
import time
import zlib
from typing import Callable, Optional

from repro_torch.core.broker import Cluster
from repro_torch.core.calqueue import make_queue
from repro_torch.core.monitor import Monitor
from repro_torch.core.state import MemoryStateBackend
from repro_torch.core.spec import (
    BROKER, CONSUMER, PRODUCER, SPE, STORE, PipelineSpec,
)
from repro_torch.core.telemetry import LatencyHistogram, Profiler, Telemetry
from repro_torch.core import faults as faults_mod


class EventHandle:
    """A scheduled event; ``cancel()`` is O(1) (lazy queue deletion)."""

    __slots__ = ("t", "fn", "cancelled")

    def __init__(self, t: float, fn: Callable[[], None]):
        self.t = t
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        self.fn = None          # drop closure references early


class HostRuntime:
    """Per-core queueing model for one emulated host."""

    def __init__(self, name: str, n_cores: int, cpu_percentage: float):
        self.name = name
        self.n_cores = max(1, n_cores)
        self.scale = 100.0 / max(1e-3, cpu_percentage)
        self.core_free = [0.0] * self.n_cores
        self.busy_s = 0.0                      # accumulated busy core-seconds

    def execute(self, now: float, service_s: float) -> float:
        """Queue a task; returns its completion time."""
        service_s *= self.scale
        free = self.core_free
        # first-minimum index, same tie-break as min(range, key=...)
        # without the per-call lambda (delivery hot path)
        i = 0 if self.n_cores == 1 else free.index(min(free))
        start = now if now > free[i] else free[i]
        free[i] = start + service_s
        self.busy_s += service_s
        return free[i]


class Engine:
    def __init__(self, spec: PipelineSpec, *, seed: int = 0,
                 monitor: Optional[Monitor] = None,
                 scheduler: Optional[str] = None) -> None:
        problems = spec.validate()
        if problems:
            raise ValueError("invalid pipeline spec:\n  " +
                             "\n  ".join(problems))
        self.spec = spec
        self.net = spec.network
        if self.net.route_mode not in ("table", "ondemand"):
            raise ValueError(
                f"unknown route_mode {self.net.route_mode!r}")
        self.seed = seed
        # NOTE: no shared engine-wide RNG on purpose — every component
        # draws from its own client_rng stream so that delivery-mode and
        # component changes cannot perturb each other's randomness.
        self._client_rngs: dict[str, random.Random] = {}
        self.delivery_mode = getattr(spec, "delivery", "wakeup")
        # fetch_mode="fused" (default): the broker coalesces same-tick
        # deliver/wakeup fan-outs into cohort events (one event, same
        # execution order); "legacy" keeps one event per partition /
        # per waiter for parity baselines.  Everything except the
        # event-loop counters is bit-identical between the two.
        self.fetch_mode = getattr(spec, "fetch_mode", "fused")
        # columnar delivery (the allocation-free hot path): fetch hands
        # subscribers zero-copy BatchViews; False materializes Record
        # lists at the fetch boundary (the pre-refactor behavior, kept
        # for parity checks and the allocation-counter baseline)
        self.columnar = bool(getattr(spec, "columnar", True))
        self.monitor = monitor or Monitor()
        # observability (core/telemetry.py): None at the defaults — the
        # telemetry-off contract is *zero* added events and RNG draws,
        # so hot paths only ever pay an `is None` check
        tcfg = getattr(spec, "telemetry", None)
        self.telemetry = Telemetry(tcfg) if tcfg is not None else None
        self.profiler = Profiler() if tcfg is not None and tcfg.profile \
            else None
        self.monitor.telemetry = self.telemetry
        self.net.profiler = self.profiler
        # durable checkpoint store (the job-manager role): survives
        # emulated host failures; SPE runtimes snapshot into it and
        # restore from it on recovery (see core/spe.py + core/state.py)
        self.state_backend = MemoryStateBackend()
        self.now = 0.0
        # event queue: "calendar" (bucketed near-future timers, the hot
        # path) or "heap" (legacy global heap).  Pop order is bit-
        # identical between the two (see core/calqueue.py).
        self.scheduler = scheduler or getattr(spec, "scheduler", "calendar")
        self._q = make_queue(self.scheduler)
        self._seq = 0
        self._stopped = False
        # event-loop statistics (benchmarks / regression tracking)
        self.n_events = 0               # events actually executed
        self.n_scheduled = 0            # events pushed onto the heap
        self.n_cancelled = 0            # events skipped via lazy deletion
        # chaos: number of concrete faults an (optional) chaos plan
        # expanded into at install time (faults_mod.install sets it)
        self.n_chaos_faults = 0

        self.hosts = {
            h.name: HostRuntime(h.name, h.n_cores, h.cpu_percentage)
            for h in spec.hosts.values()
        }

        broker_cfg = {}
        for comp in spec.components(BROKER):
            broker_cfg.update(comp.cfg)
        self.cluster = Cluster(self, spec.broker_hosts(), mode=spec.mode,
                               **broker_cfg)
        for t in spec.topics.values():
            self.cluster.create_topic(t.name, t.leader, t.replication,
                                      getattr(t, "partitions", 1))

        # instantiate component runtimes (factories live in stubs/spe)
        from repro_torch.core import spe as spe_mod
        from repro_torch.core import stubs as stubs_mod
        from repro_torch.core import store as store_mod
        self.runtimes: list = []
        for host in spec.hosts.values():
            for comp in host.components:
                if comp.role == PRODUCER:
                    rt = stubs_mod.make_producer(comp, host.name)
                elif comp.role == CONSUMER:
                    rt = stubs_mod.make_consumer(comp, host.name)
                elif comp.role == SPE:
                    rt = spe_mod.make_spe(comp, host.name)
                elif comp.role == STORE:
                    rt = store_mod.make_store(comp, host.name)
                else:           # broker: handled by the cluster
                    continue
                self.runtimes.append(rt)

    # ------------------------------------------------------------------
    # Deterministic per-client randomness
    # ------------------------------------------------------------------

    def client_rng(self, name: str) -> random.Random:
        """A stable RNG stream for one component (or protocol role).

        Streams are independent: how often one component draws cannot
        shift another component's sequence.  Derived from the engine seed
        and the client name, so runs are reproducible and the polling /
        wakeup delivery modes see identical produce-side randomness.
        """
        rng = self._client_rngs.get(name)
        if rng is None:
            rng = random.Random(
                (self.seed << 32) ^ zlib.crc32(name.encode()))
            self._client_rngs[name] = rng
        return rng

    # ------------------------------------------------------------------
    # Event loop
    # ------------------------------------------------------------------

    def schedule(self, delay: float, fn: Callable[[], None]) -> EventHandle:
        # open-coded EventHandle construction: schedule() runs once per
        # event, so the constructor call frame is measurable
        h = EventHandle.__new__(EventHandle)
        h.t = self.now + (delay if delay > 0.0 else 0.0)
        h.fn = fn
        h.cancelled = False
        self._seq += 1
        self.n_scheduled += 1
        self._q.push(h.t, self._seq, h)
        return h

    def schedule_at(self, t: float, fn: Callable[[], None]) -> EventHandle:
        return self.schedule(t - self.now, fn)

    def schedule_cohort(self, delay: float, fns, *args) -> EventHandle:
        """Same-tick cohort drain: ONE event that runs ``fns`` in order.

        Replaces a fan-out of k same-timestamp events with a single
        event occupying the first event's queue position.  Execution
        order is provably unchanged: the k events would have held
        consecutive sequence numbers (nothing else is scheduled between
        the pushes), so no other same-timestamp event could have popped
        between them, and anything the fns schedule keeps its sequence
        order relative to both the cohort and each other.  Used by the
        broker's fused fetch/notify paths (``fetch_mode="fused"``).
        """
        if len(fns) == 1:
            f0 = fns[0]
            return self.schedule(
                delay, (lambda: f0(*args)) if args else f0)

        def _drain() -> None:
            for fn in fns:
                fn(*args)

        return self.schedule(delay, _drain)

    def host_transition(self, host: str, up: bool) -> None:
        """Fault hook: notify a failed/recovered host's runtimes.

        Runtimes implementing ``on_host_down``/``on_host_up`` (SPE
        operator runtimes: volatile-state wipe / checkpoint restore) are
        called in runtimes-list order — deterministic across processes.
        """
        attr = "on_host_up" if up else "on_host_down"
        for rt in self.runtimes:
            if getattr(rt, "host", None) != host:
                continue
            hook = getattr(rt, attr, None)
            if hook is not None:
                hook(self)

    def stop(self) -> None:
        self._stopped = True

    def run(self, until: float) -> Monitor:
        faults_mod.install(self, self.spec.faults)
        self.monitor.bind_clock(lambda: self.now)
        if self.telemetry is not None:
            self.telemetry.start(self)
        self.cluster.start()
        for rt in self.runtimes:
            rt.start(self)
        pop = self._q.pop
        # The loop allocates millions of short-lived acyclic objects
        # (event handles, closures, tuples); CPython's generational GC
        # scans them for cycles that never form, costing ~20% of wall
        # time at scale.  Refcounting reclaims everything the loop
        # drops, so cycle detection is paused for the run and restored
        # after — purely a wall-clock change.
        was_gc = gc.isenabled()
        if was_gc:
            gc.disable()
        try:
            if self.profiler is not None:
                self._run_profiled(until, pop)
            else:
                while not self._stopped:
                    e = pop()
                    if e is None:
                        break
                    t, _, h = e
                    if h.cancelled:
                        self.n_cancelled += 1
                        continue
                    if t > until:
                        break
                    self.now = t
                    self.n_events += 1
                    h.fn()
        finally:
            if was_gc:
                gc.enable()
        self.now = until
        return self.monitor

    def _run_profiled(self, until: float, pop) -> None:
        """The event loop with wall-clock phase accounting.

        A separate loop so the default path stays branch-free; pop and
        dispatch wall times accumulate into locals and flush once.  Event
        *order* and counts are identical to the plain loop — the profiler
        only observes.
        """
        prof = self.profiler
        perf = time.perf_counter
        pop_wall = fn_wall = 0.0
        while not self._stopped:
            t0 = perf()
            e = pop()
            pop_wall += perf() - t0
            if e is None:
                break
            t, _, h = e
            if h.cancelled:
                self.n_cancelled += 1
                continue
            if t > until:
                break
            self.now = t
            self.n_events += 1
            t1 = perf()
            h.fn()
            fn_wall += perf() - t1
        prof.add_wall("scheduler_pop", pop_wall)
        prof.add_wall("event_fn", fn_wall)

    # ------------------------------------------------------------------
    # Structured metrics (the sweep runner's result contract)
    # ------------------------------------------------------------------

    def run_metrics(self, until: float) -> dict:
        """Run to ``until`` and return :meth:`metrics` (with wall time)."""
        t0 = time.perf_counter()
        self.run(until=until)
        return self.metrics(wall_s=time.perf_counter() - t0)

    def export_trace(self, path: str) -> dict:
        """Write this run's flight-recorder + telemetry state as Chrome
        trace-event JSON (Perfetto-loadable); requires telemetry enabled
        on the spec.  Returns the trace object."""
        from repro_torch.obs.trace import write_trace
        return write_trace(self, path)

    def metrics(self, *, wall_s: Optional[float] = None) -> dict:
        """One flat, JSON-serializable summary of a finished run.

        Every field except ``wall_s`` is deterministic for a fixed (spec,
        seed) — sweep caching, resume-equality tests and the CI gates all
        rely on that (``repro_torch.sweep.results.TIMING_KEYS`` names the
        nondeterministic ones).
        """
        mon = self.monitor
        cluster = self.cluster
        # a message is lost/partial against its topic's subscriber
        # *groups*: a group delivers each record to exactly one member,
        # and an ungrouped consumer is its own implicit group (see
        # Monitor.loss_report for the all-consumers Fig. 6 variant)
        n_subs = {t: len({cluster.group_of(c) for c in cs})
                  for t, cs in cluster.subs.items()}
        delivered = expired = truncated = lost = 0
        # per-(topic, partition) tallies, sorted keys for the
        # cross-process fingerprint contract
        part_produced: dict[str, int] = {}
        part_delivered: dict[str, int] = {}
        part_bytes: dict[str, int] = {}
        part_lat_sum: dict[str, float] = {}
        for name in sorted(cluster.topics):
            for p in range(cluster.topics[name].n_partitions):
                k = f"{name}/{p}"
                part_produced[k] = part_delivered[k] = part_bytes[k] = 0
                part_lat_sum[k] = 0.0
        for m in mon.msgs.values():
            delivered += len(m.deliveries)
            expired += m.expired_time is not None
            truncated += m.truncated_time is not None
            expected = n_subs.get(m.topic, 0)
            if expected and len(m.deliveries) < expected:
                lost += 1
            pk = f"{m.topic}/{m.partition}"
            if pk in part_produced:
                part_produced[pk] += 1
                part_delivered[pk] += len(m.deliveries)
                part_bytes[pk] += m.size * len(m.deliveries)
            for t in m.deliveries.values():
                if pk in part_lat_sum:
                    part_lat_sum[pk] += t - m.produce_time
        # per-partition mean produce→deliver latency (the partition-level
        # e2e signal; unit-based e2e stays pipeline-global)
        part_e2e = {k: (part_lat_sum[k] / part_delivered[k]
                        if part_delivered[k] else 0.0)
                    for k in sorted(part_lat_sum)}
        # explicit consumer-group lag: HW minus committed offset, summed
        # over the group's partitions at the end of the run
        group_lag: dict[str, int] = {}
        for (gname, topic), gs in sorted(cluster.groups.items()):
            if not gs.explicit:
                continue
            lag = 0
            for p, pm in enumerate(cluster.topics[topic].parts):
                log = cluster.logs[pm.leader].get((topic, p))
                hw = log.hw if log is not None else 0
                lag += max(0, hw - cluster.committed_offset(topic, p,
                                                            gname))
            group_lag[f"{gname}:{topic}"] = lag
        # delivery latency comes from the monitor's bounded histogram
        # (fed at first-delivery time): exact count/mean, bin-resolution
        # p50/p99 — no unbounded per-delivery list is ever built here
        lat_hist = mon.delivery_hist
        e2e = mon.e2e_latency()
        e2e_hist = LatencyHistogram()
        e2e_hist.add_many(e2e)
        util = self.resource_report()
        # event-time / checkpoint accounting (operator-graph SPEs):
        # window_emit events carry the emission identity (spe, key,
        # window), so duplicates re-emitted after a recovery are the
        # emission count minus the distinct identity count
        emits = mon.events_of("window_emit")
        distinct_windows = {(e["spe"], e["key"], e["start"], e["end"])
                            for e in emits}
        # degradation observability: backpressure / shedding aggregates
        # over the subscriber runtimes, plus produce-path retry/expiry
        # counters and fault-schedule totals.  All read zero at the
        # defaults (unbounded queues, no faults), so pre-existing pins
        # are unaffected; all join the sweep fingerprint automatically.
        shed = pauses = bytes_shed = q_peak = 0
        pause_s = 0.0
        for rt in self.runtimes:
            if not hasattr(rt, "n_shed"):
                continue
            shed += rt.n_shed
            bytes_shed += rt.bytes_shed
            pauses += rt.n_pauses
            pause_s += rt.pause_s
            q_peak = max(q_peak, rt._q_peak)
            # pauses still open at the horizon close against run end
            pause_s += sum(self.now - t0 for t0 in rt._bp_paused.values())
        fault_events = sum(
            len(mon.events_of(k))
            for k in ("link_down", "host_down", "gray_loss", "slow_host"))
        out = {
            "sim_s": self.now,
            "wall_s": wall_s,
            "engine_events": self.n_events,
            "events_scheduled": self.n_scheduled,
            "events_cancelled": self.n_cancelled,
            "records_produced": len(mon.msgs),
            "records_delivered": delivered,
            "records_expired": int(expired),
            "records_truncated": int(truncated),
            "lost_or_partial": lost,
            "elections": len(mon.events_of("leader_elected")),
            "isr_changes": len(mon.events_of("isr_shrink"))
            + len(mon.events_of("isr_expand")),
            "latency_count": lat_hist.n,
            "latency_mean": lat_hist.mean,
            "latency_p50": lat_hist.quantile(0.50),
            "latency_p99": lat_hist.quantile(0.99),
            "e2e_count": len(e2e),
            "e2e_sum": float(sum(e2e)),
            "e2e_mean": float(sum(e2e) / len(e2e)) if e2e else 0.0,
            "e2e_p50": e2e_hist.quantile(0.50),
            "e2e_p99": e2e_hist.quantile(0.99),
            "n_partitions": sum(m.n_partitions
                                for m in cluster.topics.values()),
            "n_groups": len({gs.group for gs in cluster.groups.values()
                             if gs.explicit}),
            "group_rebalances": len(mon.events_of("group_rebalance")),
            "produce_batches": cluster.n_produce_batches,
            # produce-path degradation: retries (leader unknown/electing/
            # moved) and delivery-timeout expiries, counted per batch.
            # Producer-side only — bit-identical across delivery modes.
            "produce_retries": cluster.n_produce_retries,
            "produce_expired": cluster.n_produce_expired,
            # chaos / backpressure / shedding (0 at the defaults)
            "chaos_faults": self.n_chaos_faults,
            "fault_events": fault_events,
            "records_shed": shed,
            "bytes_shed": bytes_shed,
            "backpressure_pauses": pauses,
            "pause_seconds": round(pause_s, 9),
            "queue_peak_bytes": q_peak,
            # Record dataclasses materialized at the delivery boundary:
            # ~0 on the columnar (BatchView) path, one per delivered row
            # with spec.columnar=False — deterministic, so CI gates the
            # allocation win on this counter instead of wall clock
            "record_objects_materialized": cluster.n_records_materialized,
            "windows_fired": len(mon.events_of("window_fired")),
            "window_emits": len(emits),
            "windows_emitted_distinct": len(distinct_windows),
            "recovered_duplicates": len(emits) - len(distinct_windows),
            "late_records": sum(e["n"]
                                for e in mon.events_of("late_records")),
            "checkpoint_count": len(mon.events_of("checkpoint")),
            "spe_recoveries": len(mon.events_of("spe_recovered")),
            "partition_produced": part_produced,
            "partition_delivered": part_delivered,
            "partition_bytes": part_bytes,
            "partition_e2e_mean": part_e2e,
            "group_lag": group_lag,
            "reach_queries": self.net.n_reach_queries,
            "path_queries": self.net.n_path_queries,
            "reach_computes": self.net.n_graph_builds,
            "max_util_pct": max(
                (h["util_pct"] for h in util.values()), default=0.0),
        }
        # observability surfaces join the dict only when enabled, so the
        # telemetry-off metrics stay key-for-key identical to the pins
        tel = self.telemetry
        if tel is not None:
            out.update(tel.metrics_fields())
        prof = self.profiler
        if prof is not None:
            # call counts are deterministic and join the fingerprint;
            # wall seconds are not (sweep.results.TIMING_KEYS excludes
            # profile_wall from cache/repeat identity checks)
            out["profile_counts"] = {
                "scheduler_pops": self.n_events,
                "netem_path": self.net.n_path_queries,
                **{k: prof.counts[k] for k in sorted(prof.counts)},
            }
            out["profile_wall"] = {
                k: prof.wall[k] for k in sorted(prof.wall)}
        return out

    # ------------------------------------------------------------------
    # Compute model hooks
    # ------------------------------------------------------------------

    def execute_on(self, host: str, service_s: float,
                   fn: Optional[Callable[[], None]] = None) -> float:
        """Run a task on a host's core model; invoke fn at completion."""
        done = self.hosts[host].execute(self.now, service_s)
        if fn is not None:
            self.schedule_at(done, fn)
        return done

    # convenience accessors -------------------------------------------------

    def consumers_named(self) -> list[str]:
        from repro_torch.core.spec import CONSUMER as C
        return [c.name for c in self.spec.components(C)]

    def resource_report(self) -> dict:
        """Fig. 9 analogue: per-host emulated core utilization."""
        horizon = max(self.now, 1e-9)
        return {
            h.name: {
                "busy_core_s": h.busy_s,
                "util_pct": 100.0 * h.busy_s / (h.n_cores * horizon),
            }
            for h in self.hosts.values()
        }
