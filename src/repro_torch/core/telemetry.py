"""Deterministic telemetry: time series, stage spans, flight recorder.

The observability layer for the emulation engine.  Four pieces, all
opt-in through :class:`TelemetryCfg` on the spec (``spec.set_telemetry``)
except the bounded delivery-latency histogram, which replaced the old
unbounded per-delivery latency list as the always-on store behind
``Engine.metrics()``'s ``latency_*`` fields:

1. **Time-series sampler** — a periodic engine event samples
   per-(topic, partition) delivered bytes/s and records/s, ISR size,
   explicit consumer-group lag, bounded-queue depth / paused state, and
   event-time watermark lag into fixed-size numpy ring buffers
   (:class:`Series`).  Samples are pure functions of sim time: no wall
   clock, no RNG, iteration over *sorted* keys and the runtimes list
   only.  Summaries (peak / mean / area) and a content digest of the
   rings enter ``Engine.metrics()`` and therefore the sweep fingerprint.

2. **Per-stage latency spans** — produce→append→replicate→fetch→
   deliver→operator→sink transitions land in fixed-bin log-spaced
   :class:`LatencyHistogram`\\ s keyed by (stage, topic): bounded memory
   regardless of run length, deterministic integer bin counts, p50/p99
   derived from the bins.  ``lineage_k > 0`` additionally records a full
   per-stage timestamp trace for the first K records of each topic.

3. **Flight recorder** — a bounded ring (:class:`FlightRecorder`) of
   monitor events, produce/deliver markers and backpressure transitions,
   exportable as Chrome trace-event JSON via :mod:`repro_torch.obs.trace`.

4. **Engine profiler** — opt-in (``profile=True``) wall-clock phase
   accounting (scheduler pops, netem path queries, fetch/deliver,
   operator processing, checkpoints).  Wall times are nondeterministic
   and excluded from the fingerprint (``profile_wall`` is in
   ``repro_torch.sweep.results.TIMING_KEYS``); the per-phase *call counts* are
   deterministic and fingerprinted (``profile_counts``).

Determinism contract (mirrors the chaos-cfg inertness rules): with
telemetry **off** (the default) this module adds zero engine events and
zero RNG draws — hot paths see a single ``is None`` check.  With
telemetry **on**, every produced artifact except the profiler wall times
is bit-identical for a fixed (spec, seed) across processes, schedulers
and the columnar axis; across delivery modes the *produce-side* series
and spans agree while delivery-timing series differ by design (poll and
wakeup deliver at different times — same as the latency metrics).
"""
from __future__ import annotations

import hashlib
import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Log-spaced histogram (bounded latency store)
# ---------------------------------------------------------------------------

# fixed global binning: 16 bins per decade over [1 µs, 1000 s), plus an
# underflow and an overflow bin.  146 int64 counters per histogram —
# bounded memory however long the run — and the same edges in every
# process, so bin counts are directly comparable and fingerprintable.
HIST_LO = 1e-6
HIST_HI = 1e3
BINS_PER_DECADE = 16
_N_DECADES = 9
_EDGES = HIST_LO * np.power(
    10.0, np.arange(_N_DECADES * BINS_PER_DECADE + 1) / BINS_PER_DECADE)
N_BINS = _EDGES.size + 1                      # + underflow + overflow
# plain-float copy for the scalar (bisect) fast path in add_many
_EDGES_LIST = [float(e) for e in _EDGES]


class LatencyHistogram:
    """Fixed-bin log-spaced histogram of nonnegative durations.

    ``add_many`` is vectorized (one ``searchsorted`` + ``bincount`` per
    delivered batch); the running ``sum`` accumulates in event order, so
    ``mean`` is deterministic for a deterministic event stream.
    Quantiles come from the bins: rank ``ceil(q*n)`` into the cumulative
    counts, reported as the geometric midpoint of the containing bin —
    full-precision floats, but *bin-resolution* values (documented where
    pins were re-captured).
    """

    __slots__ = ("_counts", "n", "sum")

    def __init__(self) -> None:
        # python-int bins: the per-delivery increment path indexes a
        # plain list (a numpy scalar += is ~10x slower); ``counts``
        # materializes the familiar int64 array on demand
        self._counts = [0] * N_BINS
        self.n = 0
        self.sum = 0.0

    @property
    def counts(self) -> np.ndarray:
        return np.asarray(self._counts, dtype=np.int64)

    def add(self, value: float) -> None:
        self._counts[bisect_right(_EDGES_LIST, value)] += 1
        self.n += 1
        self.sum += value

    def add_many(self, values) -> None:
        # scalar fast path for the common tiny delivery batch: bisect
        # beats the asarray+searchsorted+bincount round trip by ~10x.
        # Bitwise-identical to the vector path: bisect_right == side=
        # "right", and the local left-to-right accumulation reproduces
        # np.sum's sequential order exactly (numpy switches to pairwise
        # partials above 8 elements — hence the cutoff, verified by
        # tests/test_telemetry.py's histogram equivalence fuzz).
        if type(values) is list and len(values) <= 7:
            if not values:
                return
            counts = self._counts
            s = values[0]
            counts[bisect_right(_EDGES_LIST, values[0])] += 1
            for v in values[1:]:
                counts[bisect_right(_EDGES_LIST, v)] += 1
                s += v
            self.n += len(values)
            self.sum += s
            return
        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(_EDGES, arr, side="right")
        bc = np.bincount(idx, minlength=N_BINS)
        self._counts = [a + b for a, b in zip(self._counts, bc.tolist())]
        self.n += int(arr.size)
        self.sum += float(arr.sum())

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    @staticmethod
    def bin_value(i: int) -> float:
        """Deterministic representative value of bin ``i``."""
        if i <= 0:
            return float(_EDGES[0]) * 0.5
        if i >= _EDGES.size:
            return float(_EDGES[-1])
        return math.sqrt(float(_EDGES[i - 1]) * float(_EDGES[i]))

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        rank = min(self.n, max(1, int(math.ceil(q * self.n))))
        cum = 0
        for i in range(N_BINS):
            cum += self._counts[i]
            if cum >= rank:
                return self.bin_value(i)
        return self.bin_value(N_BINS - 1)   # unreachable (cum == n)

    def summary(self) -> dict:
        return {"count": self.n, "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


# ---------------------------------------------------------------------------
# Ring-buffered time series
# ---------------------------------------------------------------------------


class Series:
    """One sampled signal: a float64 ring plus exact running aggregates.

    The ring keeps the last ``slots`` samples (columnar, allocation-free
    after construction); ``sum``/``peak``/``n`` accumulate over *all*
    samples, so the peak/mean/area summaries stay exact after the ring
    wraps.
    """

    __slots__ = ("vals", "slots", "n", "sum", "peak")

    def __init__(self, slots: int) -> None:
        self.slots = slots
        self.vals = np.zeros(slots, dtype=np.float64)
        self.n = 0
        self.sum = 0.0
        self.peak = 0.0

    def push(self, v: float) -> None:
        self.vals[self.n % self.slots] = v
        self.n += 1
        self.sum += v
        if v > self.peak:
            self.peak = v

    def ring(self) -> np.ndarray:
        """Retained samples, oldest first."""
        if self.n <= self.slots:
            return self.vals[:self.n]
        i = self.n % self.slots
        return np.concatenate([self.vals[i:], self.vals[:i]])

    def summary(self, interval_s: float) -> dict:
        return {
            "n": self.n,
            "mean": self.sum / self.n if self.n else 0.0,
            "peak": self.peak,
            "area": self.sum * interval_s,
        }


# ---------------------------------------------------------------------------
# Flight recorder (bounded event ring)
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of (t, kind, args) engine happenings.

    Fed by the monitor (application events, produce/deliver markers) and
    the backpressure hooks; exported as Chrome trace-event JSON by
    :mod:`repro_torch.obs.trace`.  ``n`` counts every record ever made (a
    deterministic metric); the ring retains the last ``slots``.
    """

    __slots__ = ("buf", "slots", "n")

    def __init__(self, slots: int) -> None:
        self.slots = slots
        self.buf: list = [None] * slots
        self.n = 0

    def record(self, t: float, kind: str, args: dict) -> None:
        self.buf[self.n % self.slots] = (t, kind, args)
        self.n += 1

    def entries(self) -> list:
        """Retained entries, oldest first."""
        if self.n <= self.slots:
            return self.buf[:self.n]
        i = self.n % self.slots
        return self.buf[i:] + self.buf[:i]


# ---------------------------------------------------------------------------
# Engine profiler (opt-in)
# ---------------------------------------------------------------------------


class Profiler:
    """Per-phase call counts (deterministic) + wall seconds (not).

    ``counts`` joins the sweep fingerprint via ``profile_counts``;
    ``wall`` is excluded (``TIMING_KEYS``).  Hooks live at the phase
    boundaries (engine loop, netem ``path``, cluster fetch/deliver, SPE
    processing, checkpoints) behind ``is None`` checks, so a run without
    a profiler pays nothing.

    Fetch-path buckets: ``fetch_ctl`` (metadata resolution + control
    RTT, one count per partition attempt) and ``fetch_take``
    (offset/byte bookkeeping + response, one count per partition that
    passed the control phase) replace the former whole-call ``fetch``
    bucket so the next bottleneck hunt sees which half dominates.
    ``deliver`` counts one per delivered view in *both* fetch modes;
    fused mode adds ``deliver_cohort`` (one count + the cohort event's
    wall per landing).  All counts are deterministic; ``deliver``,
    ``fetch_ctl`` and ``fetch_take`` are identical across
    fused/legacy, ``deliver_cohort`` and ``scheduler_pops`` are the
    intentional event-count deltas.
    """

    __slots__ = ("counts", "wall")

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}
        self.wall: dict[str, float] = {}

    def add(self, phase: str, dt: float, n: int = 1) -> None:
        self.counts[phase] = self.counts.get(phase, 0) + n
        self.wall[phase] = self.wall.get(phase, 0.0) + dt

    def add_wall(self, phase: str, dt: float) -> None:
        """Wall time for a phase whose count lives elsewhere (netem
        keeps its own ``n_path_queries`` counter)."""
        self.wall[phase] = self.wall.get(phase, 0.0) + dt


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class TelemetryCfg:
    """Observability knobs (``PipelineSpec.set_telemetry``).

    interval_s     sampling cadence of the time-series ticker (must be
                   > 0; each tick is one engine event)
    ring_slots     retained samples per series ring (summaries stay
                   exact after wraparound)
    flight_slots   flight-recorder capacity (events retained for trace
                   export; the total event count stays exact)
    lineage_k      record a full per-stage timestamp trace for the
                   first K records of each topic (0 = off)
    profile        enable the engine profiler (wall-clock phase
                   accounting; call counts are fingerprinted, wall
                   times are not)
    """

    interval_s: float = 1.0
    ring_slots: int = 512
    flight_slots: int = 4096
    lineage_k: int = 0
    profile: bool = False


# ---------------------------------------------------------------------------
# The telemetry runtime
# ---------------------------------------------------------------------------


class Telemetry:
    """Engine-attached observability state (one per Engine when enabled).

    All hooks are safe to call from hot paths: span recording is one
    dict lookup + a vectorized histogram insert, delivery counting is
    two dict increments, and lineage marking fast-exits when no record
    is traced.  Sampling iterates sorted topic/group keys and the
    runtimes list (never a raw set/dict), keeping every artifact
    bit-identical across processes.
    """

    def __init__(self, cfg: TelemetryCfg) -> None:
        self.cfg = cfg
        self.n_samples = 0
        self._series: dict[str, Series] = {}
        self._spans: dict[tuple[str, str], LatencyHistogram] = {}
        self.recorder = FlightRecorder(cfg.flight_slots)
        # per-(topic, partition) cumulative delivery tallies + the
        # previous sample's cumulative values (rate = delta / interval)
        self._deliv_recs: dict[tuple[str, int], int] = {}
        self._deliv_bytes: dict[tuple[str, int], int] = {}
        self._prev: dict[tuple[str, int], tuple[int, int]] = {}
        # lineage: msg_id -> [(stage, t), ...]; per-topic admit counts
        self._lineage: dict[int, list] = {}
        self._lineage_topic: dict[int, str] = {}
        self._lineage_admitted: dict[str, int] = {}

    # -- hot-path hooks -------------------------------------------------

    def count_delivery(self, topic: str, part: int, nbytes: int) -> None:
        """One first-time delivery of a record to one consumer."""
        key = (topic, part)
        self._deliv_recs[key] = self._deliv_recs.get(key, 0) + 1
        self._deliv_bytes[key] = self._deliv_bytes.get(key, 0) + nbytes

    def span(self, stage: str, topic: str, value: float) -> None:
        key = (stage, topic)
        h = self._spans.get(key)
        if h is None:
            h = self._spans[key] = LatencyHistogram()
        h.add(value)

    def span_many(self, stage: str, topic: str, values) -> None:
        key = (stage, topic)
        h = self._spans.get(key)
        if h is None:
            h = self._spans[key] = LatencyHistogram()
        h.add_many(values)

    def flight(self, t: float, kind: str, **kw) -> None:
        self.recorder.record(t, kind, kw)

    # -- lineage traces -------------------------------------------------

    def lineage_produce(self, msg_id: int, topic: str, t: float) -> None:
        """Admit a record into lineage tracing (first K per topic)."""
        k = self.cfg.lineage_k
        if k <= 0:
            return
        seen = self._lineage_admitted.get(topic, 0)
        if seen >= k:
            return
        self._lineage_admitted[topic] = seen + 1
        self._lineage[msg_id] = [("produce", t)]
        self._lineage_topic[msg_id] = topic

    def lineage_mark(self, msg_ids, stage: str, t: float) -> None:
        lid = self._lineage
        if not lid:
            return
        for mid in msg_ids:
            tr = lid.get(mid)
            if tr is not None:
                tr.append((stage, t))

    def lineage_traces(self) -> list[dict]:
        """Traced records as dicts, msg_id-ordered (deterministic)."""
        return [{"msg_id": mid, "topic": self._lineage_topic[mid],
                 "stages": list(self._lineage[mid])}
                for mid in sorted(self._lineage)]

    # -- the sampler ----------------------------------------------------

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(self.cfg.ring_slots)
        return s

    def start(self, eng) -> None:
        eng.schedule(self.cfg.interval_s, lambda: self._sample(eng))

    def _sample(self, eng) -> None:
        self.n_samples += 1
        now = eng.now
        inv = 1.0 / self.cfg.interval_s
        cluster = eng.cluster
        for name in sorted(cluster.topics):
            meta = cluster.topics[name]
            for p in range(meta.n_partitions):
                key = (name, p)
                cr = self._deliv_recs.get(key, 0)
                cb = self._deliv_bytes.get(key, 0)
                pr, pb = self._prev.get(key, (0, 0))
                self._prev[key] = (cr, cb)
                self.series(f"recs_s:{name}/{p}").push((cr - pr) * inv)
                self.series(f"bytes_s:{name}/{p}").push((cb - pb) * inv)
                self.series(f"isr:{name}/{p}").push(
                    float(len(meta.parts[p].isr)))
        # explicit consumer-group lag (HW minus committed, summed over
        # the group's partitions) — the elasticity signal of ROADMAP #4
        for (gname, topic), gs in sorted(cluster.groups.items()):
            if not gs.explicit:
                continue
            lag = 0
            for p, pm in enumerate(cluster.topics[topic].parts):
                log = cluster.logs[pm.leader].get((topic, p))
                hw = log.hw if log is not None else 0
                lag += max(0, hw - cluster.committed_offset(
                    topic, p, gname))
            self.series(f"lag:{gname}:{topic}").push(float(lag))
        # bounded ingest queues + watermarks, runtimes-list order
        for rt in eng.runtimes:
            if getattr(rt, "queue_bytes_max", 0) > 0:
                self.series(f"queue:{rt.name}").push(float(rt._q_used))
                self.series(f"paused:{rt.name}").push(
                    1.0 if rt._bp_paused else 0.0)
            if getattr(rt, "time_mode", None) == "event":
                wm = rt._watermark(eng)
                self.series(f"wmlag:{rt.name}").push(
                    now - wm if wm > float("-inf") else 0.0)
        eng.schedule(self.cfg.interval_s, lambda: self._sample(eng))

    # -- metrics / fingerprint surface ----------------------------------

    def series_digest(self) -> str:
        """Content hash of every ring — bit-identity of the full series
        set joins the sweep fingerprint through ``metrics()``."""
        h = hashlib.sha256()
        for name in sorted(self._series):
            s = self._series[name]
            h.update(name.encode())
            h.update(str(s.n).encode())
            h.update(np.ascontiguousarray(s.ring()).tobytes())
        return h.hexdigest()

    def span_digest(self) -> str:
        """Content hash of every stage histogram's bin counts."""
        h = hashlib.sha256()
        for stage, topic in sorted(self._spans):
            hist = self._spans[(stage, topic)]
            h.update(f"{stage}:{topic}:{hist.n}".encode())
            h.update(np.ascontiguousarray(hist.counts).tobytes())
        return h.hexdigest()

    def metrics_fields(self) -> dict:
        """Telemetry's contribution to ``Engine.metrics()`` (all
        deterministic; all join the sweep fingerprint)."""
        interval = self.cfg.interval_s
        return {
            "telemetry_samples": self.n_samples,
            "telemetry_series": {
                name: self._series[name].summary(interval)
                for name in sorted(self._series)},
            "telemetry_digest": self.series_digest(),
            "stage_spans": {
                f"{stage}:{topic}": self._spans[(stage, topic)].summary()
                for stage, topic in sorted(self._spans)},
            "stage_digest": self.span_digest(),
            "lineage_records": len(self._lineage),
            "flight_events": self.recorder.n,
        }
