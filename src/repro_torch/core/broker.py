"""Replicated-log event streaming substrate with Kafka-visible semantics.

The paper's experiments (Figs. 5/6) probe *protocol* behavior of the event
streaming platform: replication, leader election, ISR management, producer
retries/timeouts, preferred-replica rebalance, and the ZooKeeper-era
divergent-log truncation that silently loses messages after a network
partition heals ([36] in the paper).  This module implements exactly that
protocol surface over the discrete-event engine:

- **Stale metadata.** Clients (producers/consumers) cache partition→leader
  metadata and refresh it only through brokers they can reach; brokers keep
  a leadership *belief* that updates only when the controller can reach
  them.  A producer co-located with a partitioned leader therefore keeps
  writing to it for the whole partition — the divergent writes.
- ``mode="zk"``   — the stale leader accepts those writes (acks=1); after
  the heal it truncates its divergent suffix to the new leader's log →
  **silent message loss** (Fig. 6b).
- ``mode="kraft"``— a leader that cannot reach a replication quorum refuses
  writes; producers buffer + retry (Kafka's 120 s ``delivery.timeout``)
  and the messages are delivered after the heal → no loss (the paper
  "could not observe a similar behavior in Raft-based Kafka").

**Partitions.**  A topic is a list of partitions; every protocol structure
(logs, leadership, ISR, beliefs, client metadata, elections, truncation)
is keyed per (topic, partition) with *independent* leaders spread over the
broker list, so a network partition can orphan a subset of a topic's
partition leaders while the rest keep serving.  Producers route records by
``hash(key) % partitions`` (crc32, so routing is stable across processes)
or round-robin when unkeyed; records with the same key land on the same
partition and are therefore delivered in produce order.

**Consumer groups.**  Subscribers carrying the same ``group`` split a
topic's partitions via a deterministic *range assignor* over the sorted
live member names; committed offsets are tracked per (group, partition) in
the cluster, so a partition handed to another member on rebalance resumes
exactly at the commit point (no re-delivery).  The controller rebalances a
group when a member's host fails or recovers and wakes all parked waiters
of the topic (``_notify``), so wakeup-mode members re-fetch under the new
assignment instead of hanging.  Ungrouped subscribers are their own
implicit group: they own every partition and never rebalance (the legacy
single-consumer behavior).

**Produce batching.**  Producers with ``linger_s > 0`` accumulate records
per (producer, topic, partition) into a pending batch that is flushed when
the linger timer fires or ``batch_bytes`` is reached (Kafka ``linger.ms``
/ ``batch.size``).  A flushed batch runs the attempt/ack/retry state
machine *once* — one leader append, one ack, one retry timer, one
replication transfer per follower — instead of once per record, and is
appended through the vectorized :meth:`RecordBatch.extend_rows`.
``linger_s == 0`` flushes a one-record batch immediately and reproduces
the legacy per-record event pattern exactly.

Brokers are in-memory (the paper's accuracy experiments do not exercise
disk).  Each per-(broker, topic, partition) log is a **columnar**
:class:`RecordBatch` — numpy columns for ``msg_id`` / ``size`` /
``produce_time`` / ``epoch`` plus a running prefix sum of sizes, and plain
payload/key lists.  Offsets are implicit (offset == row index; logs are
always dense leader prefixes), so ``fetch`` byte-capping is a
``searchsorted`` on the prefix sums, divergence truncation is a vectorized
``isin``, and catch-up byte accounting is O(1).  ``Record`` objects are
materialized only at the delivery boundary.

Delivery modes: consumers either poll (legacy fixed-interval path) or
register as **waiters**; the cluster wakes waiters when any partition's
high watermark advances (and after elections / leadership changes /
group rebalances, so a waiter pointed at a deposed leader or a stale
assignment re-resolves instead of hanging).

**Fetch-side batching.**  Symmetric to the produce batcher:
``fetch_min_bytes`` / ``fetch_max_wait_s`` broker cfg lets consumers
linger — a fetch finding fewer than ``fetch_min_bytes`` committed bytes
across its owned partitions is held until enough data accumulates or
the wait expires (one scheduled expiry event per hold cycle).  At the
defaults (``min_bytes=1`` / ``max_wait=0``) the hold branch is never
taken and the event stream is bit-identical to the pre-feature broker.

**Event time.**  Records carry a producer-stamped ``event_time``
(defaulting to produce time) in a dedicated numpy column; the SPE layer
derives per-partition watermarks from this column for event-time window
semantics (``core/spe.py``).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.kernels import cohort as cohort_kernels

# Protocol timing defaults (seconds); overridable via brokerCfg.
DEFAULTS = dict(
    session_timeout=6.0,        # leader-failure detection (ZK session / raft)
    election_time=2.0,          # leader election duration
    controller_tick=0.5,
    request_timeout=2.0,        # producer per-attempt timeout (paper Fig.3a)
    retry_backoff=0.5,
    delivery_timeout=120.0,     # Kafka default delivery.timeout.ms
    rebalance_interval=5.0,     # preferred-replica election check
    fetch_bytes=1 << 20,
    # fetch-side batching (Kafka fetch.min.bytes / fetch.max.wait.ms):
    # with min_bytes > 1 and max_wait > 0 a response holding fewer than
    # min_bytes committed bytes is *held* until enough data accumulates
    # or the wait expires.  The defaults disable lingering and are
    # event-stream-identical to the pre-feature broker (pinned in
    # tests/test_fetch_batching.py).
    fetch_min_bytes=1,
    fetch_max_wait_s=0.0,
)

# fetch() outcomes (used by the wakeup delivery loop to decide re-arming)
FETCH_DELIVERED = "delivered"            # response drained to the HW
FETCH_DELIVERED_MORE = "delivered_more"  # byte cap hit; committed rows left
FETCH_EMPTY = "empty"
FETCH_BLOCKED = "blocked"       # unreachable / electing / stale metadata


def key_partition(key: Any, n_partitions: int) -> int:
    """Stable keyed routing: crc32, not ``hash()`` (which is per-process)."""
    return zlib.crc32(str(key).encode()) % max(1, n_partitions)


@dataclass
class Record:
    msg_id: int
    topic: str
    payload: Any
    size: int
    produce_time: float
    producer: str
    offset: int = -1
    epoch: int = 0
    partition: int = 0
    key: Any = None
    # event-time semantics: the timestamp the *producer* stamped into
    # the record (defaults to produce time).  Consumers derive their
    # watermarks from this column, never from arrival times.
    event_time: float = 0.0


class RecordBatch:
    """Columnar append-only log: numpy columns + payload/key lists.

    Rows are offsets (dense, monotone).  ``cum_size[i]`` holds the total
    bytes of rows ``0..i`` so byte windows never re-scan records.
    """

    __slots__ = ("n", "msg_id", "size", "produce_time", "epoch",
                 "event_time", "cum_size", "cum_list", "payloads",
                 "producers", "keys")

    _MIN_CAP = 64

    def __init__(self) -> None:
        self.n = 0
        self.msg_id = np.empty(self._MIN_CAP, np.int64)
        self.size = np.empty(self._MIN_CAP, np.int64)
        self.produce_time = np.empty(self._MIN_CAP, np.float64)
        self.epoch = np.empty(self._MIN_CAP, np.int64)
        self.event_time = np.empty(self._MIN_CAP, np.float64)
        self.cum_size = np.empty(self._MIN_CAP, np.int64)
        # python-int mirror of cum_size[:n]: the byte-window take on the
        # fetch hot path bisects this (C-speed int compares, no numpy
        # scalar round trips); the numpy column stays authoritative for
        # vectorized slices
        self.cum_list: list[int] = []
        self.payloads: list[Any] = []
        self.producers: list[str] = []
        self.keys: list[Any] = []

    _COLS = ("msg_id", "size", "produce_time", "epoch", "event_time",
             "cum_size")

    # -- growth --------------------------------------------------------

    def _grow(self, min_cap: int = 0) -> None:
        cap = max(self._MIN_CAP, 2 * len(self.msg_id), min_cap)
        for name in self._COLS:
            col = getattr(self, name)
            new = np.empty(cap, col.dtype)
            new[:self.n] = col[:self.n]
            setattr(self, name, new)

    def append_row(self, msg_id: int, size: int, produce_time: float,
                   epoch: int, payload: Any, producer: str,
                   key: Any = None, event_time: Optional[float] = None
                   ) -> int:
        """Append one record; returns its offset."""
        i = self.n
        if i >= len(self.msg_id):
            self._grow()
        self.msg_id[i] = msg_id
        self.size[i] = size
        self.produce_time[i] = produce_time
        self.epoch[i] = epoch
        self.event_time[i] = (produce_time if event_time is None
                              else event_time)
        total = size + (self.cum_list[i - 1] if i else 0)
        self.cum_size[i] = total
        self.cum_list.append(total)
        self.payloads.append(payload)
        self.producers.append(producer)
        self.keys.append(key)
        self.n = i + 1
        return i

    def extend_rows(self, msg_ids, sizes, produce_times, epochs,
                    payloads: list, producers: list,
                    keys: Optional[list] = None,
                    event_times: Optional[list] = None) -> int:
        """Vectorized multi-row append; returns the first offset.

        Column arguments are sequences of equal length ``k``; the prefix
        sum is extended with one ``cumsum`` instead of ``k`` scalar adds
        (the produce batcher's append path).
        """
        k = len(payloads)
        if k == 0:
            return self.n
        i = self.n
        if i + k > len(self.msg_id):
            self._grow(min_cap=i + k)
        self.msg_id[i:i + k] = msg_ids
        self.size[i:i + k] = sizes
        self.produce_time[i:i + k] = produce_times
        self.epoch[i:i + k] = epochs
        self.event_time[i:i + k] = (produce_times if event_times is None
                                    else event_times)
        base = self.cum_list[i - 1] if i else 0
        cs = base + np.cumsum(np.asarray(sizes, np.int64))
        self.cum_size[i:i + k] = cs
        self.cum_list.extend(cs.tolist())
        self.payloads.extend(payloads)
        self.producers.extend(producers)
        self.keys.extend(keys if keys is not None else [None] * k)
        self.n = i + k
        return i

    # -- O(1)/O(slice) accounting --------------------------------------

    def bytes_between(self, lo: int, hi: int) -> int:
        """Total bytes of rows [lo, hi)."""
        if hi <= lo:
            return 0
        base = self.cum_list[lo - 1] if lo else 0
        return self.cum_list[hi - 1] - base

    def total_bytes(self) -> int:
        return self.cum_list[self.n - 1] if self.n else 0

    def take_by_bytes(self, lo: int, hi: int, max_bytes: int
                      ) -> tuple[int, int]:
        """Greedy byte-capped prefix of rows [lo, hi).

        Returns ``(n_rows, n_bytes)`` where the first row crossing the
        cap is still included (Kafka ``fetch.max.bytes`` semantics).
        """
        if hi <= lo:
            return 0, 0
        cum = self.cum_list
        base = cum[lo - 1] if lo else 0
        k = bisect_left(cum, base + max_bytes, lo, hi) - lo
        n = min(hi - lo, k + 1)
        return n, cum[lo + n - 1] - base

    def take_within_bytes(self, lo: int, hi: int, max_bytes: int
                          ) -> tuple[int, int]:
        """Strict byte-capped prefix of rows [lo, hi).

        Unlike :meth:`take_by_bytes`, the row crossing the cap is
        *excluded* — the returned bytes never exceed ``max_bytes``.
        Backpressure fetch budgets use this so a bounded subscriber
        queue provably never exceeds its configured bound.
        """
        if hi <= lo:
            return 0, 0
        cum = self.cum_list
        base = cum[lo - 1] if lo else 0
        k = bisect_right(cum, base + max_bytes, lo, hi) - lo
        n = min(hi - lo, k)
        if n == 0:
            return 0, 0
        return n, cum[lo + n - 1] - base

    def copy_from(self, other: "RecordBatch") -> None:
        """Become an exact copy of ``other`` (payload objects shared)."""
        self.n = other.n
        for name in self._COLS:
            setattr(self, name, getattr(other, name)[:other.n].copy())
        self.cum_list = other.cum_list[:other.n]
        self.payloads = list(other.payloads)
        self.producers = list(other.producers)
        self.keys = list(other.keys)

    def rows_not_in(self, other: "RecordBatch") -> np.ndarray:
        """Row indices whose msg_id does not appear in ``other``."""
        mask = ~np.isin(self.msg_id[:self.n], other.msg_id[:other.n])
        return np.nonzero(mask)[0]

    # -- materialization boundary ---------------------------------------

    def record_at(self, i: int, topic: str, partition: int = 0) -> Record:
        return Record(int(self.msg_id[i]), topic, self.payloads[i],
                      int(self.size[i]), float(self.produce_time[i]),
                      self.producers[i], offset=i, epoch=int(self.epoch[i]),
                      partition=partition, key=self.keys[i],
                      event_time=float(self.event_time[i]))

    def records_slice(self, topic: str, lo: int, hi: int,
                      partition: int = 0) -> list[Record]:
        return [self.record_at(i, topic, partition)
                for i in range(lo, min(hi, self.n))]


class BatchView:
    """Zero-copy columnar view over one delivered log slice.

    The allocation-free delivery boundary: ``Cluster.fetch`` hands
    subscribers a ``BatchView`` of rows ``[lo, hi)`` of one (topic,
    partition) log instead of a list of per-row :class:`Record` objects.
    Numpy column slices are views (no copy); ``payloads``/``keys`` slice
    the underlying pointer lists lazily (cached).

    **Stability**: the view captures the column array and payload-list
    *objects* at construction.  Log mutations never touch delivered rows
    in place — appends write past ``hi``, capacity growth and divergence
    truncation (``RecordBatch.copy_from``) swap in fresh arrays/lists —
    so a view delivered after an in-flight network delay still reads
    exactly the rows that were fetched, matching the eager
    materialization semantics of the legacy path bit-for-bit.

    **Compat boundary**: iteration / ``to_records()`` / ``record_at``
    materialize classic :class:`Record` objects (offsets are absolute log
    offsets, identical to ``records_slice``).  Every materialization is
    tallied in ``Cluster.n_records_materialized`` — the deterministic
    counter behind ``Engine.metrics()["record_objects_materialized"]``
    and the CI allocation gate.
    """

    __slots__ = ("topic", "partition", "lo", "hi", "_msg_id", "_size",
                 "_pt", "_et", "_epoch", "_plist", "_klist", "_prods",
                 "_cum", "_counter", "_payloads", "_keys")

    def __init__(self, batch: RecordBatch, topic: str, lo: int, hi: int,
                 partition: int = 0, counter=None) -> None:
        self.topic = topic
        self.partition = partition
        self.lo = lo
        self.hi = hi
        self._msg_id = batch.msg_id
        self._size = batch.size
        self._pt = batch.produce_time
        self._et = batch.event_time
        self._epoch = batch.epoch
        self._cum = batch.cum_list
        self._plist = batch.payloads
        self._klist = batch.keys
        self._prods = batch.producers
        self._counter = counter          # Cluster (materialization tally)
        self._payloads = None
        self._keys = None

    def __len__(self) -> int:
        return self.hi - self.lo

    # -- columnar access (zero-copy numpy slices) ----------------------

    @property
    def msg_id(self) -> np.ndarray:
        return self._msg_id[self.lo:self.hi]

    @property
    def size(self) -> np.ndarray:
        return self._size[self.lo:self.hi]

    @property
    def produce_time(self) -> np.ndarray:
        return self._pt[self.lo:self.hi]

    @property
    def event_time(self) -> np.ndarray:
        return self._et[self.lo:self.hi]

    @property
    def payloads(self) -> list:
        if self._payloads is None:
            self._payloads = self._plist[self.lo:self.hi]
        return self._payloads

    @property
    def keys(self) -> list:
        if self._keys is None:
            self._keys = self._klist[self.lo:self.hi]
        return self._keys

    # -- python-scalar columns (one C conversion, no per-row numpy) ----

    def msg_ids(self) -> list[int]:
        return self._msg_id[self.lo:self.hi].tolist()

    def sizes(self) -> list[int]:
        return self._size[self.lo:self.hi].tolist()

    def event_times(self) -> list[float]:
        return self._et[self.lo:self.hi].tolist()

    def total_bytes(self) -> int:
        lo, hi = self.lo, self.hi
        if hi <= lo:
            return 0
        base = self._cum[lo - 1] if lo else 0
        return self._cum[hi - 1] - base

    # -- Record materialization (compat boundary; counted) -------------

    def _count(self, n: int) -> None:
        if self._counter is not None:
            self._counter.n_records_materialized += n

    def subview(self, lo: int, hi: int) -> "BatchView":
        """A narrower view over view-relative rows [lo, hi) — no copy,
        no Record materialization (load shedding keeps contiguous runs
        of an already-delivered view through this)."""
        v = BatchView.__new__(BatchView)
        for s in BatchView.__slots__:
            setattr(v, s, getattr(self, s))
        v.lo = self.lo + max(0, lo)
        v.hi = min(self.hi, self.lo + hi)
        v._payloads = None
        v._keys = None
        return v

    def record_at(self, i: int) -> Record:
        """Materialize view row ``i`` (0-based within the view)."""
        self._count(1)
        j = self.lo + i
        return Record(int(self._msg_id[j]), self.topic, self._plist[j],
                      int(self._size[j]), float(self._pt[j]),
                      self._prods[j], offset=j, epoch=int(self._epoch[j]),
                      partition=self.partition, key=self._klist[j],
                      event_time=float(self._et[j]))

    def to_records(self) -> list[Record]:
        return [self.record_at(i) for i in range(len(self))]

    def __iter__(self):
        for i in range(len(self)):
            yield self.record_at(i)


def payloads_of(records) -> list:
    """Payload list of a delivered batch (view or Record list)."""
    if isinstance(records, BatchView):
        return records.payloads
    return [r.payload for r in records]


@dataclass
class PartitionMeta:
    """Leadership/ISR state of one (topic, partition)."""

    topic: str
    partition: int
    replicas: list[str]                  # broker hosts, preferred first
    leader: str
    isr: set[str]
    epoch: int = 0
    electing_until: float = -1.0         # partition unavailable electing
    leader_lost_since: Optional[float] = None
    isr_since: dict = field(default_factory=dict)   # broker -> join time


class TopicMeta:
    """A partitioned topic: ordered :class:`PartitionMeta` list.

    Attribute proxies (``leader``/``replicas``/``isr``/``epoch``/
    ``electing_until``) forward to partition 0, preserving the
    pre-partition single-log surface that tests and tooling built on
    ``cluster.topics[t].leader`` still rely on.
    """

    def __init__(self, name: str, parts: list[PartitionMeta]) -> None:
        self.name = name
        self.parts = parts
        # shared by assigned_partitions() for implicit solo groups —
        # the partition list is fixed at create_topic time and callers
        # only iterate, so one list serves every fetch
        self._all_parts = list(range(len(parts)))

    @property
    def n_partitions(self) -> int:
        return len(self.parts)

    # single-partition compat shims (field moved to PartitionMeta)
    @property
    def leader(self) -> str:
        return self.parts[0].leader

    @property
    def replicas(self) -> list[str]:
        return self.parts[0].replicas

    @property
    def isr(self) -> set[str]:
        return self.parts[0].isr

    @property
    def epoch(self) -> int:
        return self.parts[0].epoch

    @property
    def electing_until(self) -> float:
        return self.parts[0].electing_until


@dataclass
class GroupState:
    """Membership + current partition assignment of one (group, topic)."""

    group: str
    topic: str
    explicit: bool                      # False: implicit solo group
    members: list = field(default_factory=list)     # runtimes, join order
    live: tuple = ()
    assignment: Optional[dict[str, list[int]]] = None
    generation: int = 0


@dataclass
class _PendingBatch:
    """One in-flight produce batch (single (topic, partition) target)."""

    batch_id: int
    records: list[Record]
    producer_host: str
    first_attempt: float
    acked: bool = False
    retry_handle: Any = None             # cancellable EventHandle

    @property
    def topic(self) -> str:
        return self.records[0].topic

    @property
    def partition(self) -> int:
        return self.records[0].partition

    @property
    def producer(self) -> str:
        return self.records[0].producer

    @property
    def nbytes(self) -> int:
        return sum(r.size for r in self.records)


@dataclass
class _Accum:
    """Per-(producer, topic, partition) linger accumulator."""

    producer_host: str
    records: list[Record] = field(default_factory=list)
    nbytes: int = 0
    flush_handle: Any = None


class _LogMap(dict):
    """Per-broker log map keyed by (topic, partition).

    Compat shim: a bare topic string indexes partition 0, so pre-partition
    callers (``cluster.logs[b]["t"]``) keep working.
    """

    @staticmethod
    def _key(k):
        return (k, 0) if isinstance(k, str) else k

    def __getitem__(self, k):
        return dict.__getitem__(self, self._key(k))

    def __setitem__(self, k, v):
        dict.__setitem__(self, self._key(k), v)

    def __contains__(self, k):
        return dict.__contains__(self, self._key(k))

    def get(self, k, default=None):
        return dict.get(self, self._key(k), default)


class ReplicaLog:
    """One broker's copy of one (topic, partition) log (columnar)."""

    def __init__(self, topic: str = "", partition: int = 0) -> None:
        self.topic = topic
        self.partition = partition
        self.batch = RecordBatch()
        self.hw: int = 0                 # high watermark (committed offsets)

    @property
    def leo(self) -> int:                # log end offset
        return self.batch.n

    @property
    def records(self) -> list[Record]:
        """Materialized view (tests / debugging; not on the hot path)."""
        return self.batch.records_slice(self.topic, 0, self.batch.n,
                                        self.partition)

    def append(self, rec: Record) -> Record:
        off = self.batch.append_row(rec.msg_id, rec.size, rec.produce_time,
                                    rec.epoch, rec.payload, rec.producer,
                                    rec.key, event_time=rec.event_time)
        return dataclasses.replace(rec, offset=off)

    def append_batch(self, records: list[Record],
                     epoch: Optional[int] = None) -> list[Record]:
        """Vectorized append; returns offset-stamped (epoch-stamped) copies."""
        k = len(records)
        epochs = ([epoch] * k if epoch is not None
                  else [r.epoch for r in records])
        first = self.batch.extend_rows(
            [r.msg_id for r in records], [r.size for r in records],
            [r.produce_time for r in records], epochs,
            [r.payload for r in records], [r.producer for r in records],
            [r.key for r in records],
            [r.event_time for r in records])
        return [dataclasses.replace(r, offset=first + j, epoch=epochs[j])
                for j, r in enumerate(records)]

    def truncate_to(self, other: "ReplicaLog") -> list[Record]:
        """Make this log a copy of ``other``; return locally-lost records."""
        lost_rows = self.batch.rows_not_in(other.batch)
        lost = [self.batch.record_at(int(i), self.topic, self.partition)
                for i in lost_rows]
        self.batch.copy_from(other.batch)
        self.hw = other.hw
        return lost


class Cluster:
    """Controller + brokers.  All timing flows through ``engine.schedule``."""

    def __init__(self, engine, broker_hosts: list[str], mode: str = "zk",
                 **cfg) -> None:
        self.engine = engine
        self.mode = mode
        self.cfg = {**DEFAULTS, **{k: v for k, v in cfg.items()
                                   if k in DEFAULTS}}
        # fetch-path cfg pins: cfg is frozen after construction, so the
        # hot per-fetch dict lookups collapse to attribute reads
        self._fetch_bytes = self.cfg["fetch_bytes"]
        self._fetch_min_bytes = self.cfg["fetch_min_bytes"]
        self._fetch_max_wait_s = self.cfg["fetch_max_wait_s"]
        self.broker_hosts = list(broker_hosts)
        self.controller_host = self.broker_hosts[0] if broker_hosts else None
        # logs[broker][(topic, partition)] -> ReplicaLog
        self.logs: dict[str, _LogMap] = {b: _LogMap() for b in broker_hosts}
        self.topics: dict[str, TopicMeta] = {}
        self.subs: dict[str, list] = {}          # topic -> consumer comps
        # (group, topic) -> GroupState; ungrouped = implicit solo group
        self.groups: dict[tuple[str, str], GroupState] = {}
        # committed offsets per (topic, partition, group)
        self._consumer_offsets: dict[tuple[str, int, str], int] = {}
        # fetch responses ride one ordered connection per subscription:
        # (topic, consumer) -> sim time the last in-flight response lands
        self._inflight_until: dict[tuple[str, str], float] = {}
        self._pending: dict[int, _PendingBatch] = {}
        # (producer, topic, partition) -> open linger accumulator
        self._accum: dict[tuple[str, str, int], _Accum] = {}
        # idempotent-producer sequencing: per (producer, topic,
        # partition) FIFO of pending batch ids; only the head is ever in
        # flight, so retried batches cannot leapfrog each other and
        # reorder a partition log after a leader failover (Kafka with
        # enable.idempotence, the >=3.0 default).  Fault-free runs never
        # queue more than one batch — the ack lands before the next
        # flush — so the legacy event stream is unchanged.
        self._seq_q: dict[tuple[str, str, int], list[int]] = {}
        self._rr: dict[tuple[str, str], int] = {}   # round-robin counters
        self._msg_seq = 0
        self._batch_seq = 0
        self.n_produce_batches = 0      # flushed batches (produce requests)
        # degradation observability (fingerprinted via Engine.metrics):
        # produce-path retries (backoff reschedules + NOT_LEADER bounces)
        # and batches expired past delivery_timeout.  Both live on the
        # produce path, which draws only producer-side RNG streams, so
        # they are bit-identical across delivery modes.
        self.n_produce_retries = 0
        self.n_produce_expired = 0
        # delivery-boundary Record materializations (deterministic; the
        # columnar BatchView path keeps this at ~0, the legacy record
        # path pays one per delivered row — see Engine.metrics)
        self.n_records_materialized = 0
        # columnar=False materializes Record lists at fetch time (the
        # pre-BatchView delivery pattern, kept for parity + baselines)
        self.columnar = bool(getattr(engine, "columnar", True))
        # client metadata: (client, topic, partition) -> believed leader
        self._client_meta: dict[tuple[str, str, int], str] = {}
        # broker belief: (broker, topic, partition) -> (is_leader, epoch)
        self._belief: dict[tuple[str, str, int], tuple[bool, int]] = {}
        # wakeup delivery: topic -> {consumer_name: consumer runtime}
        self._waiters: dict[str, dict[str, Any]] = {}
        # fetch-side batching: (topic, consumer) -> deadline of the
        # current below-min-bytes hold (see fetch()).  The *deadline* is
        # stored, not the hold start: the expiry event lands at exactly
        # `now + max_wait` (the same float expression), so the
        # comparison at expiry is exact — re-deriving it as
        # `now - held < max_wait` loses to rounding about a third of
        # the time and would re-park the waiter with no timer left.
        self._hold_deadline: dict[tuple[str, str], float] = {}
        # fetch_mode="fused" (default): one cohort deliver event per
        # (subscriber, fetch cycle, landing time) and one cohort wakeup
        # event per _notify fan-out, instead of one event per partition
        # / per waiter.  Execution order is provably identical (see
        # Engine.schedule_cohort); only the event-loop counters differ.
        self._fused = str(getattr(engine, "fetch_mode", "fused")) \
            == "fused"
        # assigned-partitions memo: (consumer, topic) -> (generation,
        # sorted partition tuple); invalidated by the generation bump in
        # _assign (rebalance), never recomputed on the fetch hot path
        self._ap_cache: dict[tuple[str, str], tuple[int, tuple]] = {}

    def _log(self, broker: str, topic: str, partition: int = 0
             ) -> ReplicaLog:
        key = (topic, partition)
        rl = self.logs[broker].get(key)
        if rl is None:
            rl = self.logs[broker][key] = ReplicaLog(topic, partition)
        return rl

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------

    def create_topic(self, name: str, leader: Optional[str] = None,
                     replication: int = 1, partitions: int = 1) -> None:
        assert self.broker_hosts, "no brokers in the pipeline"
        nb = len(self.broker_hosts)
        i0 = (self.broker_hosts.index(leader) if leader is not None
              else len(self.topics) % nb)
        parts = []
        for p in range(max(1, partitions)):
            # independent leaders, rotated over the broker list so one
            # broker failure orphans only a subset of the partitions
            lead = self.broker_hosts[(i0 + p) % nb]
            others = [b for b in self.broker_hosts if b != lead]
            replicas = [lead] + others[:max(0, replication - 1)]
            parts.append(PartitionMeta(name, p, replicas, lead,
                                       isr=set(replicas)))
            for b in self.broker_hosts:
                self._belief[(b, name, p)] = (b == lead, 0)
            for b in replicas:
                self.logs[b][(name, p)] = ReplicaLog(name, p)
        self.topics[name] = TopicMeta(name, parts)

    def subscribe(self, consumer, topic: str,
                  group: Optional[str] = None) -> None:
        self.subs.setdefault(topic, []).append(consumer)
        group = group or getattr(consumer, "group", None)
        explicit = group is not None
        gname = group or consumer.name
        meta = self.topics[topic]
        for p in range(meta.n_partitions):
            self._consumer_offsets.setdefault((topic, p, gname), 0)
        gs = self.groups.get((gname, topic))
        if gs is None:
            gs = self.groups[(gname, topic)] = GroupState(
                gname, topic, explicit)
        gs.members.append(consumer)

    def start(self) -> None:
        self.engine.schedule(self.cfg["controller_tick"],
                             self._controller_tick)

    # ------------------------------------------------------------------
    # Consumer groups (range assignor + failure-driven rebalance)
    # ------------------------------------------------------------------

    def group_of(self, consumer) -> str:
        return getattr(consumer, "group", None) or consumer.name

    def assigned_partitions(self, consumer, topic: str):
        """Partitions this subscriber currently owns (deterministic).

        Memoized per (consumer, topic) against the group's rebalance
        generation — the fetch hot path and ``_avail_bytes`` used to
        recompute the group-dict chain on every call.  A rebalance bumps
        ``gs.generation`` (see ``_assign``), which invalidates the entry
        on the next lookup; solo groups never rebalance and share the
        topic's precomputed ``_all_parts``.
        """
        meta = self.topics.get(topic)
        if meta is None:
            return ()
        gs = self.groups.get((self.group_of(consumer), topic))
        if gs is None or not gs.explicit:
            # implicit solo group: owns everything, never rebalances
            return meta._all_parts
        key = (consumer.name, topic)
        cached = self._ap_cache.get(key)
        if cached is not None and cached[0] == gs.generation:
            return cached[1]
        if gs.assignment is None:
            self._assign(gs)
        parts = tuple(gs.assignment.get(consumer.name, ()))
        self._ap_cache[key] = (gs.generation, parts)
        return parts

    def _assign(self, gs: GroupState,
                live: Optional[tuple] = None) -> None:
        """Range assignor: contiguous partition ranges over sorted live
        member names — deterministic for a fixed membership."""
        if live is None:
            net = self.engine.net
            live = tuple(sorted(m.name for m in gs.members
                                if net.host_up(m.host)))
        n_parts = self.topics[gs.topic].n_partitions
        gs.live = live
        gs.generation += 1
        gs.assignment = {}
        m = len(live)
        for i, name in enumerate(live):
            gs.assignment[name] = list(range(i * n_parts // m,
                                             (i + 1) * n_parts // m))

    def _rebalance_groups(self, now: float) -> None:
        """Reassign any explicit group whose live membership changed."""
        net = self.engine.net
        for (gname, topic), gs in self.groups.items():
            if not gs.explicit or gs.assignment is None:
                continue
            live = tuple(sorted(m.name for m in gs.members
                                if net.host_up(m.host)))
            if live != gs.live:
                self._assign(gs, live)
                self.engine.monitor.event(
                    now, "group_rebalance", group=gname, topic=topic,
                    members=list(live), generation=gs.generation)
                # waiters parked under the stale assignment must re-fetch
                self._notify(topic)

    def committed_offset(self, topic: str, partition: int,
                         group: str) -> int:
        return self._consumer_offsets.get((topic, partition, group), 0)

    def seek(self, topic: str, partition: int, group: str,
             offset: int) -> None:
        """Rewind (or advance) a group's committed offset — the recovery
        path: a restored SPE resumes from its checkpointed input offsets
        and the records past them are re-fetched (at-least-once)."""
        self._consumer_offsets[(topic, partition, group)] = int(offset)

    # ------------------------------------------------------------------
    # Wakeup delivery (event-driven subscribers)
    # ------------------------------------------------------------------

    def wait_for_data(self, consumer, topic: str) -> None:
        """Park a subscriber until one of the topic's HWs advances."""
        self._waiters.setdefault(topic, {})[consumer.name] = consumer

    def _notify(self, topic: str) -> None:
        """Wake every parked subscriber of ``topic``.

        Legacy mode schedules one zero-delay event per waiter; fused
        mode drains the fan-out as one same-tick cohort event running
        the same wakeups in the same order (Engine.schedule_cohort —
        the k events would have held consecutive sequence numbers, so
        nothing could pop between them and anything the wakeups
        schedule keeps its relative order either way)."""
        waiting = self._waiters.get(topic)
        if not waiting:
            return
        eng = self.engine
        consumers = list(waiting.values())
        waiting.clear()
        if self._fused:
            eng.schedule_cohort(0.0, [c.on_wakeup for c in consumers],
                                eng, topic)
        else:
            for c in consumers:
                eng.schedule(0.0, lambda c=c: c.on_wakeup(eng, topic))

    # ------------------------------------------------------------------
    # Client metadata (stale caches refreshed via reachable brokers)
    # ------------------------------------------------------------------

    def _client_leader(self, client_host: str, client_name: str,
                       topic: str, partition: int) -> Optional[str]:
        key = (client_name, topic, partition)
        cached = self._client_meta.get(key)
        if cached is not None:
            return cached
        net = self.engine.net
        for b in self.broker_hosts:       # metadata request to any broker
            if net.host_up(b) and net.reachable(client_host, b):
                leader = self.topics[topic].parts[partition].leader
                self._client_meta[key] = leader
                return leader
        return None

    def _invalidate_client(self, client_name: str, topic: str,
                           partition: int) -> None:
        self._client_meta.pop((client_name, topic, partition), None)

    # ------------------------------------------------------------------
    # Produce path (keyed routing + linger batching)
    # ------------------------------------------------------------------

    def next_msg_id(self) -> int:
        self._msg_seq += 1
        return self._msg_seq

    def _route(self, producer_name: str, topic: str, key: Any) -> int:
        n_parts = self.topics[topic].n_partitions
        if n_parts <= 1:
            return 0
        if key is not None:
            return key_partition(key, n_parts)
        rr_key = (producer_name, topic)
        i = self._rr.get(rr_key, 0)
        self._rr[rr_key] = i + 1
        return i % n_parts

    def produce(self, producer_host: str, producer_name: str, topic: str,
                payload: Any, size: int, *, key: Any = None,
                linger_s: float = 0.0, batch_bytes: int = 1 << 14,
                event_time: Optional[float] = None) -> int:
        """Producer API.  Returns msg_id; delivery is asynchronous.

        ``key`` selects the partition (``crc32(key) % partitions``;
        round-robin when ``None``).  ``linger_s > 0`` accumulates records
        per (producer, topic, partition) and flushes the batch on the
        linger timeout or when ``batch_bytes`` is reached; ``linger_s ==
        0`` flushes a single-record batch immediately (legacy behavior).
        ``event_time`` is the producer-stamped event timestamp carried in
        the log's event-time column (default: produce time).
        """
        now = self.engine.now
        part = self._route(producer_name, topic, key)
        rec = Record(self.next_msg_id(), topic, payload, size, now,
                     producer_name, partition=part, key=key,
                     event_time=now if event_time is None else event_time)
        self.engine.monitor.produced(rec)
        if linger_s <= 0.0:
            self._start_batch([rec], producer_host)
            return rec.msg_id
        akey = (producer_name, topic, part)
        acc = self._accum.get(akey)
        if acc is None:
            acc = self._accum[akey] = _Accum(producer_host)
        acc.records.append(rec)
        acc.nbytes += size
        if acc.nbytes >= batch_bytes:
            self._flush_accum(akey)
        elif acc.flush_handle is None:
            acc.flush_handle = self.engine.schedule(
                linger_s, lambda: self._flush_accum(akey))
        return rec.msg_id

    def _flush_accum(self, akey: tuple) -> None:
        acc = self._accum.pop(akey, None)
        if acc is None or not acc.records:
            return
        if acc.flush_handle is not None:
            acc.flush_handle.cancel()
            acc.flush_handle = None
        self._start_batch(acc.records, acc.producer_host)

    def _start_batch(self, records: list[Record],
                     producer_host: str) -> None:
        self._batch_seq += 1
        self.n_produce_batches += 1
        bid = self._batch_seq
        # the delivery.timeout budget starts when the first record was
        # produced (Kafka counts linger time), not at flush — identical
        # for linger 0, where flush time == produce time
        pend = _PendingBatch(bid, records, producer_host,
                             records[0].produce_time)
        self._pending[bid] = pend
        q = self._seq_q.setdefault(self._seq_key(pend), [])
        q.append(bid)
        if len(q) == 1:                 # head: send now; else wait in FIFO
            self._attempt_produce(bid)

    @staticmethod
    def _seq_key(pend: _PendingBatch) -> tuple[str, str, int]:
        return (pend.producer, pend.topic, pend.partition)

    def _finish_batch(self, pend: _PendingBatch) -> None:
        """Batch left the pending set (acked or expired): send the next
        queued batch of its (producer, topic, partition), preserving
        produce order."""
        q = self._seq_q.get(self._seq_key(pend))
        if q and q[0] == pend.batch_id:
            q.pop(0)
            if q:
                self._attempt_produce(q[0])

    def _retry_later(self, bid: int) -> None:
        self.n_produce_retries += 1
        h = self.engine.schedule(
            self.cfg["retry_backoff"] + self.cfg["request_timeout"],
            lambda: self._attempt_produce(bid))
        pend = self._pending.get(bid)
        if pend is not None:
            pend.retry_handle = h

    def _attempt_produce(self, bid: int) -> None:
        eng = self.engine
        now = eng.now
        pend = self._pending.get(bid)
        if pend is None or pend.acked:
            return
        pend.retry_handle = None
        topic, part = pend.topic, pend.partition
        q = self._seq_q.get(self._seq_key(pend))
        if q and q[0] != bid:
            return          # not the head: resent when the head finishes
        if now - pend.first_attempt > self.cfg["delivery_timeout"]:
            self.n_produce_expired += 1
            for rec in pend.records:
                eng.monitor.expired(rec, now)   # producer gives up
            del self._pending[bid]
            self._finish_batch(pend)
            return
        leader = self._client_leader(pend.producer_host, pend.producer,
                                     topic, part)
        if leader is None:
            self._retry_later(bid)
            return
        pm = self.topics[topic].parts[part]
        if now < pm.electing_until and leader == pm.leader:
            self._retry_later(bid)
            return
        delay, lost = eng.net.transfer(pend.producer_host, leader,
                                       pend.nbytes,
                                       eng.client_rng(pend.producer))
        if delay is None or lost:
            # cached leader unreachable: drop the cache so the next attempt
            # refreshes metadata through any reachable broker.
            self._invalidate_client(pend.producer, topic, part)
            self._retry_later(bid)
            return
        eng.schedule(delay, lambda: self._broker_append(leader, bid))

    def _broker_append(self, broker: str, bid: int) -> None:
        eng = self.engine
        pend = self._pending.get(bid)
        if pend is None or pend.acked:
            return
        topic, part = pend.topic, pend.partition
        pm = self.topics[topic].parts[part]
        believes, bepoch = self._belief[(broker, topic, part)]
        if not believes:
            # NOT_LEADER response: refresh metadata and retry
            self.n_produce_retries += 1
            self._invalidate_client(pend.producer, topic, part)
            pend.retry_handle = eng.schedule(
                self.cfg["retry_backoff"],
                lambda: self._attempt_produce(bid))
            return
        if self.mode == "kraft" and not self._quorum_reachable(broker, pm):
            # Raft: a leader that cannot reach a quorum refuses the write.
            self._retry_later(bid)
            return
        log = self._log(broker, topic, part)
        appended = log.append_batch(pend.records, epoch=bepoch)
        nbytes = pend.nbytes
        eng.monitor.broker_rx(broker, nbytes)
        tel = eng.telemetry
        if tel is not None:
            now = eng.now
            tel.span_many("append", topic,
                          [now - r.produce_time for r in appended])
            if tel._lineage:
                tel.lineage_mark([r.msg_id for r in appended],
                                 "append", now)
        # Kafka default acks=1: ack once the (believed) leader has the
        # batch.  Consumer visibility waits for the high watermark; an
        # isolated stale leader acks writes that never commit cluster-wide
        # — those are the Fig. 6b losses after truncation.
        self._ack(bid, appended)
        self._maybe_commit(topic, part)   # single-replica ISR commits here
        self._replicate(broker, pm, appended, nbytes)

    def _replicate(self, broker: str, pm: PartitionMeta,
                   records: list[Record], nbytes: int) -> None:
        eng = self.engine
        rep_rng = eng.client_rng("cluster:replication")
        first_off = records[0].offset
        # iterate in replicas order, not set order: the shared rep_rng
        # stream makes follower order part of the deterministic contract
        # (ISR is always a subset of replicas), and set order varies with
        # per-process hash randomization — sweep caching would diverge.
        # The fan-out is one homogeneous (src, nbytes) cohort, so the
        # delay arithmetic runs as a single vectorized transfer_many
        # (bit-identical to per-follower transfer calls, RNG order
        # included).
        followers = [x for x in pm.replicas if x in pm.isr and x != broker]
        for b, (delay, lost) in zip(
                followers,
                eng.net.transfer_many(broker, followers, nbytes, rep_rng)):
            if delay is None or lost:
                continue   # follower unreachable; controller manages ISR
            eng.monitor.broker_tx(broker, nbytes)

            def _deliver(b=b):
                rl = self._log(b, pm.topic, pm.partition)
                if rl.leo == first_off:       # in-order replication only
                    rl.append_batch(records)
                    eng.monitor.broker_rx(b, nbytes)
                    tel = eng.telemetry
                    if tel is not None:
                        now = eng.now
                        tel.span_many(
                            "replicate", pm.topic,
                            [now - r.produce_time for r in records])
                    self._maybe_commit(pm.topic, pm.partition)

            eng.schedule(delay, _deliver)

    def _maybe_commit(self, topic: str, partition: int = 0) -> None:
        """Advance HW to min(LEO) over the partition's ISR; wake waiters."""
        pm = self.topics[topic].parts[partition]
        logs = [self.logs[b].get((topic, partition)) for b in pm.isr]
        if any(l is None for l in logs):
            return
        hw = min(l.leo for l in logs)
        advanced = False
        for l in logs:
            new_hw = max(l.hw, min(hw, l.leo))
            if new_hw != l.hw:
                l.hw = new_hw
                advanced = True
        if advanced:
            self._notify(topic)

    def _ack(self, bid: int, appended: list[Record]) -> None:
        pend = self._pending.pop(bid, None)
        if pend is not None:
            pend.acked = True
            if pend.retry_handle is not None:
                pend.retry_handle.cancel()      # lazy heap deletion
                pend.retry_handle = None
            self._finish_batch(pend)
        now = self.engine.now
        for rec in appended:
            self.engine.monitor.committed(rec, now)

    def _quorum_reachable(self, broker: str, pm: PartitionMeta) -> bool:
        net = self.engine.net
        live = sum(1 for b in pm.replicas if net.reachable(broker, b))
        return live > len(pm.replicas) // 2

    # ------------------------------------------------------------------
    # Fetch path (consumers poll, or are woken by _notify)
    # ------------------------------------------------------------------

    def fetch(self, consumer, topic: str) -> str:
        """Deliver committed records past the group's offsets on every
        partition this subscriber owns.

        Returns a combined FETCH_* status so the wakeup delivery loop can
        decide whether to re-fetch, park as a waiter, or back off:
        any partition byte-capped → ``delivered_more``; else any blocked
        → ``blocked`` (interval retries under faults); else park.
        """
        return self._fetch(consumer, topic)

    def _fetch(self, consumer, topic: str) -> str:
        """One fused fetch cycle over every owned partition.

        The per-partition work is a single flat pass with every
        per-fetch-invariant lookup (group, cfg, metadata dicts, budget
        hook, telemetry) hoisted out of the loop; byte accounting reads
        the ``cum_list`` prefix-sum mirrors.  RNG draw order — one
        control RTT then one data transfer per partition, in assignment
        order — is exactly the legacy sequence, so loss/fault behavior
        is untouched.  ``fetch_mode`` only controls how the responses
        are *scheduled*: legacy posts one deliver event per partition,
        fused groups consecutive equal-landing-time responses into
        cohort events (``t_land`` is non-decreasing across the loop, so
        equal values are always adjacent — see kernels/cohort.py).
        """
        eng = self.engine
        rng = eng.client_rng(consumer.name)
        # fetch.min.bytes lingering: with fewer than fetch_min_bytes
        # committed bytes available the response is *held* — the
        # subscriber parks as a waiter (wakeup) or keeps polling (poll)
        # and a one-shot expiry event forces delivery after
        # fetch_max_wait_s.  Disabled at the defaults (min_bytes=1 or
        # max_wait=0): this branch is never entered, so the event stream
        # is bit-identical to the pre-feature broker.
        min_b = self._fetch_min_bytes
        max_w = self._fetch_max_wait_s
        prof = eng.profiler
        if min_b > 1 and max_w > 0:
            t0 = time.perf_counter() if prof is not None else 0.0
            hkey = (topic, consumer.name)
            avail = self._avail_bytes(consumer, topic)
            if 0 < avail < min_b:
                deadline = self._hold_deadline.get(hkey)
                if deadline is None:
                    self._hold_deadline[hkey] = eng.now + max_w
                    eng.schedule(max_w,
                                 lambda: self._expire_hold(hkey))
                    if prof is not None:
                        prof.add_wall("fetch_ctl",
                                      time.perf_counter() - t0)
                    return FETCH_EMPTY
                if eng.now < deadline:
                    if prof is not None:
                        prof.add_wall("fetch_ctl",
                                      time.perf_counter() - t0)
                    return FETCH_EMPTY
            self._hold_deadline.pop(hkey, None)
            if prof is not None:
                prof.add_wall("fetch_ctl", time.perf_counter() - t0)
        parts = self.assigned_partitions(consumer, topic)
        if not parts:
            return FETCH_EMPTY
        # --- hoisted per-fetch invariants (one lookup per poll, not
        # one per partition per poll) ---------------------------------
        now = eng.now
        net = eng.net
        mon = eng.monitor
        tel = eng.telemetry
        columnar = self.columnar
        pms = self.topics[topic].parts
        cname = consumer.name
        chost = consumer.host
        owner = self.group_of(consumer)
        cmeta = self._client_meta
        offs = self._consumer_offsets
        logs = self.logs
        belief = self._belief
        cap = self._fetch_bytes
        fb = getattr(consumer, "fetch_budget", None)
        inflight = self._inflight_until
        ikey = (topic, cname)
        fused = self._fused
        pend: Optional[list] = [] if fused else None
        tx_hosts: list = []             # per-response leader/bytes for
        tx_bytes: list = []             # one batched broker_tx tally
        any_more = any_blocked = any_delivered = False
        for part in parts:
            # -- control phase: metadata resolution + request RTT ------
            t0 = time.perf_counter() if prof is not None else 0.0
            pm = pms[part]
            leader = cmeta.get((cname, topic, part))
            if leader is None:
                leader = self._client_leader(chost, cname, topic, part)
            ok = leader is not None
            if ok:
                if now < pm.electing_until and leader == pm.leader:
                    ok = False
                else:
                    rtt, lost = net.transfer(chost, leader, 64, rng)
                    if rtt is None or lost:
                        self._invalidate_client(cname, topic, part)
                        ok = False
                    elif not belief[(leader, topic, part)][0]:
                        # NOT_LEADER: stale client metadata
                        self._invalidate_client(cname, topic, part)
                        ok = False
            if prof is not None:
                prof.add("fetch_ctl", time.perf_counter() - t0)
            if not ok:
                any_blocked = True
                continue
            # -- take phase: offset/byte bookkeeping + response --------
            t1 = time.perf_counter() if prof is not None else 0.0
            log = logs[leader].get((topic, part))
            if log is None:
                if prof is not None:
                    prof.add("fetch_take", time.perf_counter() - t1)
                continue                            # empty partition
            okey = (topic, part, owner)
            off = offs[okey]
            hw = log.hw
            if off >= hw:
                if prof is not None:
                    prof.add("fetch_take", time.perf_counter() - t1)
                continue                            # drained partition
            batchlog = log.batch
            # fetch.max.bytes caps one response (remainder next fetch);
            # a bounded subscriber (pause policy) additionally caps the
            # take at its remaining ingest budget (strict — see
            # take_within_bytes), byte-identical to the legacy path at
            # the budget=None default
            budget = fb() if fb is not None else None
            if budget is None:
                n, nbytes = batchlog.take_by_bytes(off, hw, cap)
            else:
                n, nbytes = batchlog.take_within_bytes(
                    off, hw, min(cap, budget))
                if n == 0:
                    if consumer.queue_empty():
                        # a single record larger than the bound:
                        # deliver it anyway rather than deadlock
                        # (documented overshoot)
                        n, nbytes = batchlog.take_by_bytes(
                            off, hw, min(cap, budget))
                    else:
                        # committed rows remain but the budget cannot
                        # admit the next one: flag the subscriber
                        # starved so its loop parks paused instead of
                        # busy-polling; report byte-capped so no waiter
                        # is parked either way
                        consumer.bp_starve()
                        any_more = True
                        if prof is not None:
                            prof.add("fetch_take",
                                     time.perf_counter() - t1)
                        continue
            delay, lost = net.transfer(leader, chost, nbytes, rng)
            if delay is None or lost:
                any_blocked = True
                if prof is not None:
                    prof.add("fetch_take", time.perf_counter() - t1)
                continue
            offs[okey] = off + n
            if budget is not None:
                consumer.bp_reserve(nbytes)
            tx_hosts.append(leader)
            tx_bytes.append(nbytes)
            # the zero-copy delivery boundary: a BatchView over the
            # fetched rows (stable under later log mutations).  The
            # legacy record path materializes it eagerly, exactly like
            # the old records_slice, and pays the per-row counter.
            view = BatchView(batchlog, topic, off, off + n, part,
                             counter=self)
            batch = view if columnar else view.to_records()
            mids = view.msg_ids()
            # stage spans: produce→fetch at request time, produce→
            # deliver at landing time; per-view inserts (one histogram
            # float accumulation per response — never concatenated
            # across views, per the cohort contract in ROADMAP.md)
            pts = view.produce_time if tel is not None else None
            if tel is not None:
                tel.span_many("fetch", topic, now - pts)
            # TCP-ordered responses: a small later response must not
            # overtake a big in-flight one.  All partitions of a
            # subscription multiplex over the one connection, so t_land
            # is non-decreasing across this loop.
            t_land = max(now + rtt + delay, inflight.get(ikey, 0.0))
            inflight[ikey] = t_land
            if fused:
                pend.append((t_land, batch, mids, pts))
            else:
                eng.schedule(
                    t_land - now,
                    lambda b=batch, m=mids, p=pts:
                        self._deliver_one(consumer, topic, b, m, p))
            if prof is not None:
                prof.add("fetch_take", time.perf_counter() - t1)
            if off + n < hw:
                any_more = True
            else:
                any_delivered = True
        if tx_hosts:
            # integer per-leader byte tallies: associative, so the
            # batched form is fingerprint-identical to per-partition
            # broker_tx calls (kernels/cohort.py seam)
            for h, nb in cohort_kernels.int_tallies(
                    tx_hosts, tx_bytes).items():
                mon.broker_tx(h, nb)
        if pend:
            # one cohort deliver event per distinct landing time; the
            # per-partition events it replaces would have carried
            # consecutive sequence numbers, so executing the views in
            # order inside one event preserves the pop order exactly
            for lo, hi in cohort_kernels.group_spans(
                    [p[0] for p in pend]):
                group = pend[lo:hi]
                eng.schedule(
                    group[0][0] - now,
                    lambda g=group:
                        self._deliver_cohort(consumer, topic, g))
        if any_more:
            return FETCH_DELIVERED_MORE
        if any_blocked:
            return FETCH_BLOCKED
        return FETCH_DELIVERED if any_delivered else FETCH_EMPTY

    def _avail_bytes(self, consumer, topic: str) -> int:
        """Committed bytes past the group's offsets over owned partitions
        (broker-side view; drives the fetch.min.bytes hold decision).

        Reads the python-int ``cum_list`` prefix-sum mirror directly —
        two list indexings per partition per hold check instead of the
        ``bytes_between`` call chain — over the memoized assignment.
        The arithmetic is identical (``bytes_between`` is exactly this
        expression), so the hold/expiry event stream is unchanged
        (asserted in tests/test_fetch_batching.py).
        """
        owner = self.group_of(consumer)
        offs = self._consumer_offsets
        pms = self.topics[topic].parts
        logs = self.logs
        total = 0
        for p in self.assigned_partitions(consumer, topic):
            log = logs[pms[p].leader].get((topic, p))
            if log is None:
                continue
            hw = log.hw
            off = offs.get((topic, p, owner), 0)
            if off < hw:
                cum = log.batch.cum_list
                total += cum[hw - 1] - (cum[off - 1] if off else 0)
        return total

    def _expire_hold(self, hkey: tuple[str, str]) -> None:
        """fetch.max.wait expiry: wake the held subscriber if it is
        parked (wakeup mode); polling subscribers re-check on their own
        cadence and deliver once the deadline has passed."""
        if hkey not in self._hold_deadline:
            return                    # delivered (or drained) meanwhile
        topic, cname = hkey
        waiting = self._waiters.get(topic)
        c = waiting.pop(cname, None) if waiting else None
        if c is not None:
            eng = self.engine
            eng.schedule(0.0, lambda: c.on_wakeup(eng, topic))

    def _deliver_one(self, consumer, topic: str, batch, mids,
                     pts) -> None:
        """Legacy response landing: one deliver event per partition."""
        eng = self.engine
        prof = eng.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        now = eng.now
        eng.monitor.delivered_many(mids, consumer.name, now)
        tel = eng.telemetry
        if tel is not None:
            tel.span_many("deliver", topic, now - pts)
            tel.lineage_mark(mids, "deliver", now)
        consumer.on_records(eng, batch)
        if prof is not None:
            prof.add("deliver", time.perf_counter() - t0)

    def _deliver_cohort(self, consumer, topic: str, group) -> None:
        """Fused response landing: one event for every response of one
        fetch cycle that lands at the same instant.

        The monitor/telemetry tallies run per view in legacy order —
        ``delivered_many`` and ``span_many`` accumulate float histograms
        whose grouping must not change (the no-concatenation rule in the
        ROADMAP cohort contract) — then the subscriber ingests the whole
        cohort through ``on_records_cohort`` (per-view processing, with
        per-cohort invariants hoisted; see core/subscription.py).
        """
        eng = self.engine
        prof = eng.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        now = eng.now
        mon = eng.monitor
        tel = eng.telemetry
        cname = consumer.name
        for _t, batch, mids, pts in group:
            mon.delivered_many(mids, cname, now)
            if tel is not None:
                tel.span_many("deliver", topic, now - pts)
                tel.lineage_mark(mids, "deliver", now)
        if len(group) == 1:
            consumer.on_records(eng, group[0][1])
        else:
            consumer.on_records_cohort(eng, [g[1] for g in group])
        if prof is not None:
            # `deliver` counts stay per-view (cross-mode comparable);
            # the cohort event's wall and count land in deliver_cohort
            prof.add("deliver", 0.0, n=len(group))
            prof.add("deliver_cohort", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # Controller: failure detection, election, ISR, preferred rebalance
    # ------------------------------------------------------------------

    def _controller_tick(self) -> None:
        eng = self.engine
        now = eng.now
        net = eng.net
        ctrl = self.controller_host
        # controller failover: first broker holding a majority view
        if ctrl is None or not net.host_up(ctrl) \
                or not self._ctrl_has_majority(ctrl):
            for b in self.broker_hosts:
                if net.host_up(b) and self._ctrl_has_majority(b):
                    ctrl = self.controller_host = b
                    break
        for meta in self.topics.values():
            for pm in meta.parts:
                self._sync_beliefs(pm, ctrl)
                self._check_leader(pm, ctrl, now)
                self._manage_isr(pm, ctrl, now)
                self._preferred_rebalance(pm, ctrl, now)
        self._rebalance_groups(now)
        eng.schedule(self.cfg["controller_tick"], self._controller_tick)

    def _ctrl_has_majority(self, host: str) -> bool:
        net = self.engine.net
        n = sum(1 for b in self.broker_hosts if net.reachable(host, b))
        return n > len(self.broker_hosts) // 2

    def _sync_beliefs(self, pm: PartitionMeta,
                      ctrl: Optional[str]) -> None:
        """Brokers reachable from the controller learn the current epoch."""
        if ctrl is None:
            return
        net = self.engine.net
        for b in self.broker_hosts:
            if net.reachable(ctrl, b):
                was_leader, _ = self._belief[(b, pm.topic, pm.partition)]
                is_leader = b == pm.leader
                self._belief[(b, pm.topic, pm.partition)] = (is_leader,
                                                             pm.epoch)
                if was_leader and not is_leader:
                    # deposed leader rejoins: truncate divergence
                    self._catch_up(b, pm)

    def _check_leader(self, pm: PartitionMeta, ctrl: Optional[str],
                      now: float) -> None:
        if ctrl is None:
            return
        net = self.engine.net
        if net.reachable(ctrl, pm.leader) and net.host_up(pm.leader):
            pm.leader_lost_since = None
            return
        if pm.leader_lost_since is None:
            pm.leader_lost_since = now
            return
        grace = (self.cfg["session_timeout"] if self.mode == "zk"
                 else self.cfg["session_timeout"] / 2)
        if now - pm.leader_lost_since < grace or now < pm.electing_until:
            return
        # elect: prefer reachable ISR members; zk may fall back unclean
        cands = [b for b in pm.replicas
                 if b != pm.leader and net.reachable(ctrl, b)]
        isr_cands = [b for b in cands if b in pm.isr]
        pick = (isr_cands or (cands if self.mode == "zk" else []))
        if not pick:
            return
        new_leader = pick[0]
        old = pm.leader
        pm.leader = new_leader
        pm.epoch += 1
        pm.isr = {b for b in pm.replicas
                  if net.reachable(new_leader, b)}
        pm.isr.add(new_leader)
        pm.isr.discard(old)
        pm.electing_until = now + self.cfg["election_time"]
        pm.leader_lost_since = None
        self._belief[(new_leader, pm.topic, pm.partition)] = (True, pm.epoch)
        self.engine.monitor.event(now, "leader_elected", topic=pm.topic,
                                  partition=pm.partition, old=old,
                                  new=new_leader, epoch=pm.epoch)
        # Waiters parked on the deposed leader must re-resolve metadata;
        # commit (and re-notify) once the election window closes.
        self._notify(pm.topic)
        self.engine.schedule(
            self.cfg["election_time"],
            lambda: self._post_election(pm.topic, pm.partition))

    def _post_election(self, topic: str, partition: int) -> None:
        self._maybe_commit(topic, partition)
        self._notify(topic)

    def _manage_isr(self, pm: PartitionMeta, ctrl: Optional[str],
                    now: float) -> None:
        net = self.engine.net
        leader = pm.leader
        if ctrl is None or not net.reachable(ctrl, leader):
            return      # ISR changes must go through the controller
        # replicas order, not set order (same determinism contract as
        # _replicate: shrink events and commit/notify order must not
        # depend on per-process hash randomization)
        for b in [x for x in pm.replicas if x in pm.isr]:
            if b != leader and not net.reachable(leader, b):
                pm.isr.discard(b)
                self._maybe_commit(pm.topic, pm.partition)
                self.engine.monitor.event(now, "isr_shrink",
                                          topic=pm.topic,
                                          partition=pm.partition, broker=b)
        for b in pm.replicas:
            if b not in pm.isr and net.reachable(leader, b) \
                    and net.host_up(b):
                self._catch_up(b, pm)
                pm.isr.add(b)
                pm.isr_since[b] = now
                self.engine.monitor.event(now, "isr_expand",
                                          topic=pm.topic,
                                          partition=pm.partition, broker=b)

    def _catch_up(self, b: str, pm: PartitionMeta) -> None:
        """Rejoining replica truncates divergence and copies leader's log.

        zk mode loses the stale leader's partition-era writes here (paper
        Fig. 6b): records that exist only in the rejoining replica are
        dropped.
        """
        leader_log = self._log(pm.leader, pm.topic, pm.partition)
        rl = self._log(b, pm.topic, pm.partition)
        if rl is leader_log:
            return
        lost = rl.truncate_to(leader_log)
        nbytes = leader_log.batch.total_bytes()
        if nbytes:
            self.engine.monitor.broker_tx(pm.leader, nbytes)
            self.engine.monitor.broker_rx(b, nbytes)
        for r in lost:
            if r.epoch < pm.epoch:
                self.engine.monitor.truncated(r, self.engine.now)

    def _preferred_rebalance(self, pm: PartitionMeta, ctrl: Optional[str],
                             now: float) -> None:
        preferred = pm.replicas[0]
        stable = (now - pm.isr_since.get(preferred, -1e9)
                  >= self.cfg["rebalance_interval"])
        if (pm.leader != preferred and preferred in pm.isr and stable
                and ctrl is not None
                and self.engine.net.reachable(ctrl, preferred)
                and now >= pm.electing_until):
            old = pm.leader
            self._catch_up(preferred, pm)
            pm.leader = preferred
            pm.epoch += 1
            self._belief[(preferred, pm.topic, pm.partition)] = (True,
                                                                 pm.epoch)
            self._belief[(old, pm.topic, pm.partition)] = (False, pm.epoch)
            self.engine.monitor.event(now, "preferred_leader_restored",
                                      topic=pm.topic,
                                      partition=pm.partition, old=old,
                                      new=preferred, epoch=pm.epoch)
            self._maybe_commit(pm.topic, pm.partition)
            self._notify(pm.topic)
