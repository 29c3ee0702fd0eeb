"""Stream processing engine runtime: operator graphs over keyed state.

Since the event-time refactor the SPE is an **operator chain**
(:mod:`repro_torch.core.operators`): each runtime drives a composable list of
stateful operators (``Map`` / ``Filter`` / ``KeyBy`` / ``TumblingWindow``
/ ``SlidingWindow`` / ``WindowAggregate`` / ``Sink``) instead of one
monolithic query function.  Two time modes (``timeMode`` cfg):

``processing`` (default, the legacy surface)
    Batches are pushed through the chain as they arrive; ``window > 0``
    keeps the old processing-time buffer + flush timer.  This path is
    scheduled exactly like the pre-refactor runtime and reproduces its
    event streams bit-for-bit (pinned in ``tests/test_metrics_pin.py``).

``event``
    Producers stamp ``event_time`` into records
    (:mod:`repro_torch.core.stubs`), brokers carry the column per partition
    (:class:`~repro_torch.core.broker.RecordBatch`), and the runtime derives
    its **watermark** as the min over its owned partitions' running-max
    event times.  Window panes fire when the watermark passes
    ``window_end + allowed_lateness``.

    *Determinism*: a record is **late** iff its event time trails its
    *own partition's* running max by more than ``allowedLateness`` — a
    per-partition criterion, deterministic regardless of how partitions
    interleave across the ``poll``/``wakeup`` delivery modes.  Sketch of
    why no on-time record can miss its window: the window fires only
    once *every* owned partition's max event time passed
    ``end + lateness``; a record from partition p arriving later
    therefore trails p's max by more than ``lateness`` whenever its
    event time is inside the window — i.e. it is late by the
    per-partition rule.  Window contents are thus a pure function of the
    per-partition record sequences, and firing order is sorted
    ``(window_start, key)`` — identical across delivery modes and
    processes (the sweep fingerprint contract).

    *Idle partitions*: an owned partition that never receives a record
    pins the watermark at -inf and no window ever fires — the classic
    idle-partition stall, surfaced deterministically instead of papered
    over with wall-clock idleness timeouts (which would break the
    determinism contract).  Feed every partition (unkeyed round-robin
    does) or shrink the partition count / key space accordingly.

**Checkpointed recovery** (``checkpointInterval > 0``): every interval
the runtime snapshots operator state + per-partition processed offsets
to a :class:`~repro_torch.core.state.StateBackend` (durable, outside the
emulated host).  A ``host_down`` fault wipes the volatile state; on
recovery the controller restores the latest snapshot and seeks the
committed input offsets back to the checkpointed positions, replaying
the suffix.  ``semantics`` selects the emission contract:

- ``at_least_once`` — results are produced when windows fire; windows
  that fired after the last checkpoint fire *again* on replay
  (``recovered_duplicates`` in :meth:`Engine.metrics` counts them);
- ``exactly_once`` — results are buffered and only produced at the next
  checkpoint (a transactional sink); uncommitted outputs die with the
  host and are regenerated by replay, so the output topic sees every
  window exactly once.

Legacy queries (Table II applications + §V-C reproductions + LM jobs)
are reimplemented as operator chains behind the :class:`Query` compat
shim — per-record queries are ``Map``/``StatefulMap`` stages, whole-
batch queries a single ``BatchOp`` stage — with the original
``query(spe, eng, records)`` call signature preserved:

  split, count, avg_len_by_topic            — word count pipeline
  sentiment                                 — unstructured data
  ride_select                               — join/groupby/window, stateful
  maritime                                  — windowed counts → ext. store
  fraud_svm                                 — ML prediction (linear SVM)
  traffic_metrics                           — Ocampo traffic monitoring
  lm_generate                               — serve an LM over the stream
  lm_train                                  — train an LM on the stream
  identity                                  — passthrough

The queries with tensor compute (``sentiment``, ``ride_select``,
``fraud_svm``, ``traffic_metrics``, ``lm_generate``, ``lm_train``) run
it on ``resolve_device(comp.get("device"))``: ``cuda`` unless the spec
says ``device="cpu"``, and no fallback without a GPU.  Results are read
back to the host inside the query, so the SPE's measured wall
(``spe_exec``) covers the device work.
"""
from __future__ import annotations

import collections
import copy
import functools
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core import state as state_mod
from repro_torch.core.broker import BatchView
from repro_torch.core.operators import (
    BatchOp, ColumnBatch, Element, KeyBy, Map, OpContext, OperatorChain,
    SlidingWindow, StatefulMap, TumblingWindow, WindowAggregate,
    jit_bucket,
)
from repro_torch.core.spec import Component
from repro_torch.core.stubs import PER_BYTE_S, PER_RECORD_S
from repro_torch.core.subscription import DeliveryLoop

__all__ = ["SPERuntime", "make_spe", "Query", "QUERIES", "jit_bucket",
           "WINDOW_BASE_S", "build_event_chain", "elements_of"]

WINDOW_BASE_S = 200e-6


def elements_of(records) -> list[Element]:
    """Normalize a delivered batch (:class:`~repro_torch.core.broker.BatchView`
    / ``Record`` list / ``Element`` list) to operator elements.

    The view branch reads the columns directly — no intermediate
    ``Record`` dataclasses — with python-scalar conversion done in one C
    pass (``tolist``), so payload-visible values (sizes, event times)
    stay plain ints/floats exactly as on the legacy path."""
    if isinstance(records, BatchView):
        return [Element(p, s, t, k)
                for p, s, t, k in zip(records.payloads, records.sizes(),
                                      records.event_times(), records.keys)]
    if records and isinstance(records[0], Element):
        return list(records)
    return [Element(r.payload, r.size, getattr(r, "event_time", 0.0),
                    getattr(r, "key", None)) for r in records]


def _batch_nbytes(records) -> int:
    if isinstance(records, BatchView):
        return records.total_bytes()
    return sum(r.size for r in records)


# ---------------------------------------------------------------------------
# SPE runtime
# ---------------------------------------------------------------------------


class SPERuntime(DeliveryLoop):
    def __init__(self, comp: Component, host: str):
        self.init_subscriber(
            comp, host, [comp.get("inTopic") or comp.get("topic")])
        self.in_topic = self.topics[0]
        self.out_topic = comp.get("outTopic")
        self.query_name = comp.get("query", "identity")
        self.window_s = float(comp.get("window", 0.0))
        self.time_mode = comp.get("timeMode", "processing")
        self.allowed_lateness = float(comp.get("allowedLateness", 0.0))
        self.checkpoint_interval = float(comp.get("checkpointInterval", 0.0))
        self.semantics = comp.get("semantics", "at_least_once")
        self.query = query_class(self.query_name)(comp)
        if self.time_mode == "event":
            self.chain = build_event_chain(comp, self.query)
        else:
            # the compat adapter (query.__call__) runs this same chain,
            # so checkpoints cover the processing-mode state too
            self.chain = self.query.chain
        self._query_init = self.query.attr_snapshot()
        self.buffer: list = []
        self.outputs: list = []            # retained for assertions
        self.n_processed = 0
        self.late_records = 0
        self.alive = True
        self._maxet: dict[int, float] = {}     # partition -> max event time
        self._proc_off: dict[int, int] = {}    # partition -> next offset
        self._pending_out: list[Element] = []  # exactly_once: uncommitted
        self._ckpt_epoch = 0
        self.backend: Optional[state_mod.StateBackend] = None
        self._ctx = OpContext(None, self)

    # consumer-side ---------------------------------------------------------

    def start(self, eng) -> None:
        state_dir = self.comp.get("stateDir")
        self.backend = (state_mod.make_backend(state_dir) if state_dir
                        else eng.state_backend)
        self._ctx = OpContext(eng, self)
        self.chain.open(self._ctx)
        self.start_delivery(eng, [self.in_topic])
        if self.window_s > 0 and self.time_mode != "event":
            eng.schedule(self.window_s, lambda: self.flush(eng))
        if self.checkpoint_interval > 0:
            eng.schedule(self.checkpoint_interval,
                         lambda: self._checkpoint_tick(eng))

    def on_records_cohort(self, eng, batches) -> None:
        """Cohort ingest: the liveness gate is hoisted — no event can
        pop between the views of one cohort event, so ``alive`` (and
        ``_bp_epoch``) cannot change mid-cohort and checking once is
        provably equivalent to the per-view check.  Each view is then
        ingested in landing order: per-partition offset bookkeeping,
        admission and watermark advancement are order-sensitive and
        stay per-view (ROADMAP cohort contract)."""
        if not self.alive:
            return                    # host is down: in-flight cohort dies
        for b in batches:
            self._ingest_one(eng, b)

    def on_records(self, eng, records) -> None:
        if not self.alive:
            return                    # host is down: in-flight batch dies
        self._ingest_one(eng, records)

    def _ingest_one(self, eng, records) -> None:
        if isinstance(records, BatchView):
            # one fetch response covers one partition's dense row range
            self._proc_off[records.partition] = records.hi
        else:
            for r in records:
                self._proc_off[r.partition] = r.offset + 1
        # offsets above already advanced: anything shed at admission is
        # consumed-but-dropped, never replayed (delivered rows untouched)
        records = self.bp_admit(eng, records)
        if self.queue_bytes_max > 0 and not len(records):
            return
        if self.time_mode == "event":
            self._ingest_event(eng, records)
        elif self.window_s > 0:
            # buffer lightweight Elements, never Records — the flush
            # path only needs (payload, size, event_time, key)
            self.buffer.extend(elements_of(records))
            if self.queue_bytes_max > 0:
                # buffered rows hand off to the window flush; the ingest
                # queue's job (bounding the fetch path) is done
                self.bp_drain(eng, _batch_nbytes(records), self._bp_epoch)
        else:
            self._process(eng, records)

    def flush(self, eng) -> None:
        batch, self.buffer = self.buffer, []
        if batch:
            self._process(eng, batch)
        eng.schedule(self.window_s, lambda: self.flush(eng))

    # processing-time path (legacy; bit-for-bit with the pre-refactor
    # runtime — pinned) ------------------------------------------------------

    def _process(self, eng, records) -> None:
        nbytes = _batch_nbytes(records)
        service = (WINDOW_BASE_S + PER_RECORD_S * len(records)
                   + PER_BYTE_S * nbytes)
        t0 = time.perf_counter()
        results = self.query(self, eng, records)   # REAL compute, now
        wall = time.perf_counter() - t0
        prof = eng.profiler
        if prof is not None:
            prof.add("operator", wall)
        self.n_processed += len(records)
        if self.query.measure_wall:
            eng.monitor.event(eng.now, "spe_exec", spe=self.name,
                              wall=wall, records=len(records))

        ep = self._bp_epoch

        def _emit():
            if not self.alive:
                return
            for payload, size in results:
                self.outputs.append(payload)
                if self.out_topic:
                    eng.cluster.produce(self.host, self.name, self.out_topic,
                                        payload, size)
            if self.queue_bytes_max > 0:
                self.bp_drain(eng, nbytes, ep)

        done = eng.execute_on(self.host, service, _emit)
        tel = eng.telemetry
        if tel is not None:
            # operator span: queueing + service time of this batch on
            # the host compute model (sim time, deterministic)
            tel.span("operator", self.in_topic, done - eng.now)

    # event-time path (watermarks + window firing) ---------------------------

    def _watermark(self, eng) -> float:
        parts = eng.cluster.assigned_partitions(self, self.in_topic)
        if not parts:
            return float("-inf")
        return min(self._maxet.get(p, float("-inf")) for p in parts)

    def _ingest_event(self, eng, records) -> None:
        prof = eng.profiler
        t_prof = time.perf_counter() if prof is not None else 0.0
        if isinstance(records, BatchView):
            outs, n_late = self._ingest_view(records)
        else:
            elems: list[Element] = []
            n_late = 0
            for r in records:
                et = r.event_time
                prev = self._maxet.get(r.partition)
                if prev is not None and et + self.allowed_lateness < prev:
                    n_late += 1        # late by its own partition's clock
                    continue
                if prev is None or et > prev:
                    self._maxet[r.partition] = et
                elems.append(Element(r.payload, r.size, et, r.key))
            outs = self.chain.process(elems, self._ctx)
        if n_late:
            self.late_records += n_late
            eng.monitor.event(eng.now, "late_records", spe=self.name,
                              n=n_late)
        self.n_processed += len(records)
        outs += self.chain.advance_watermark(self._watermark(eng),
                                             self._ctx)
        if prof is not None:
            prof.add("operator", time.perf_counter() - t_prof)
        nbytes = _batch_nbytes(records)
        service = (WINDOW_BASE_S + PER_RECORD_S * len(records)
                   + PER_BYTE_S * nbytes)
        ep = self._bp_epoch
        if self.semantics == "exactly_once" and self.checkpoint_interval > 0:
            # transactional sink: hold results until the checkpoint
            # commits them (uncommitted outputs die with the host)
            self._pending_out.extend(outs)
            if self.queue_bytes_max > 0:
                done = eng.execute_on(self.host, service,
                                      lambda: self.bp_drain(eng, nbytes, ep))
            else:
                # fn=None schedules no event — keeps unbounded runs
                # event-count-identical to the pre-backpressure build
                done = eng.execute_on(self.host, service)
        else:
            def _emit_and_drain():
                self._emit_elems(eng, outs)
                if self.queue_bytes_max > 0:
                    self.bp_drain(eng, nbytes, ep)
            done = eng.execute_on(self.host, service, _emit_and_drain)
        tel = eng.telemetry
        if tel is not None:
            tel.span("operator", self.in_topic, done - eng.now)

    def _ingest_view(self, view: BatchView) -> tuple[list[Element], int]:
        """Columnar event-time ingest: per-partition lateness against the
        running max, then the chain's ``process_cols`` fast path.

        The sequential late/max scan is the same float comparisons, in
        the same order, as the per-record path — a view covers exactly
        one partition, so the running max is a plain local."""
        ets = view.event_times()
        part = view.partition
        lat = self.allowed_lateness
        prev = self._maxet.get(part, float("-inf"))
        keep: Optional[list[int]] = None      # None = nothing dropped yet
        n_late = 0
        for i, et in enumerate(ets):
            if et + lat < prev:
                n_late += 1
                if keep is None:
                    keep = list(range(i))
                continue
            if et > prev:
                prev = et
            if keep is not None:
                keep.append(i)
        if ets:
            self._maxet[part] = prev
        payloads, sizes, keys = view.payloads, view.sizes(), view.keys
        if keep is None:
            cols = ColumnBatch(payloads, sizes, ets, keys)
        else:
            cols = ColumnBatch([payloads[i] for i in keep],
                               [sizes[i] for i in keep],
                               [ets[i] for i in keep],
                               [keys[i] for i in keep])
        return self.chain.process_cols(cols, self._ctx), n_late

    def _emit_elems(self, eng, elems: list[Element]) -> None:
        if not self.alive:
            return
        for e in elems:
            self.outputs.append(e.payload)
            if e.window is not None:
                eng.monitor.event(eng.now, "window_emit", spe=self.name,
                                  key=e.window[0], start=e.window[1],
                                  end=e.window[2])
            if self.out_topic:
                eng.cluster.produce(
                    self.host, self.name, self.out_topic, e.payload,
                    e.size, key=e.key,
                    event_time=(e.event_time if self.time_mode == "event"
                                else None))

    # checkpointing + recovery ----------------------------------------------

    def _snapshot(self) -> dict:
        return {
            "epoch": self._ckpt_epoch,
            "chain": self.chain.snapshot(),
            "attrs": self.query.attr_snapshot(),
            "buffer": list(self.buffer),
            "maxet": dict(self._maxet),
            "proc_off": dict(self._proc_off),
        }

    def _checkpoint_tick(self, eng) -> None:
        if self.alive:
            if self._pending_out:
                pend, self._pending_out = self._pending_out, []
                self._emit_elems(eng, pend)    # commit held outputs first
            self._ckpt_epoch += 1
            prof = eng.profiler
            t0 = time.perf_counter() if prof is not None else 0.0
            self.backend.put(self.name, self._snapshot())
            if prof is not None:
                prof.add("checkpoint", time.perf_counter() - t0)
            eng.monitor.event(eng.now, "checkpoint", spe=self.name,
                              epoch=self._ckpt_epoch,
                              offsets=dict(sorted(self._proc_off.items())))
        eng.schedule(self.checkpoint_interval,
                     lambda: self._checkpoint_tick(eng))

    def on_host_down(self, eng) -> None:
        """Host failure: volatile operator state is lost."""
        self.alive = False
        self.chain.reset()
        self.query.attr_restore(self._query_init)
        self.buffer = []
        self._maxet = {}
        self._proc_off = {}
        self._pending_out = []
        # queued-but-unprocessed bytes die with the host; in-flight
        # drains for them are stale (epoch bump ignores them) and any
        # paused loop resumes into interval retries until recovery
        self.bp_reset(eng)

    def on_host_up(self, eng) -> None:
        """Recovery: restore the latest checkpoint and seek the committed
        input offsets back to the checkpointed positions (records past
        them replay).  Without checkpointing this is a cold restart —
        accumulated state and any unfired windows are simply lost."""
        self.alive = True
        snap = (self.backend.latest(self.name)
                if self.backend is not None and self.checkpoint_interval > 0
                else None)
        if snap is None:
            eng.monitor.event(eng.now, "spe_cold_restart", spe=self.name)
            return
        self.chain.restore(snap["chain"])
        self.query.attr_restore(snap["attrs"])
        self.buffer = list(snap["buffer"])
        self._maxet = dict(snap["maxet"])
        self._proc_off = dict(snap["proc_off"])
        self._ckpt_epoch = snap["epoch"]
        group = eng.cluster.group_of(self)
        for p in eng.cluster.assigned_partitions(self, self.in_topic):
            eng.cluster.seek(self.in_topic, p, group,
                             self._proc_off.get(p, 0))
        # the seek may have re-opened committed data behind a *parked*
        # waiter (this runtime drained the topic and parked before the
        # fault; the HW never advances again once producers finished) —
        # wake the topic's waiters so the rewound suffix actually
        # replays.  Runtimes holding a scheduled fetch instead are not
        # in the waiter set, so the one-of-{fetch event, waiter}
        # invariant is preserved.
        eng.cluster._notify(self.in_topic)
        eng.monitor.event(eng.now, "spe_recovered", spe=self.name,
                          epoch=self._ckpt_epoch)


def make_spe(comp: Component, host: str) -> SPERuntime:
    return SPERuntime(comp, host)


def build_event_chain(comp: Component, query: "Query") -> OperatorChain:
    """Event-time chain from cfg: ``chain`` (explicit operator list) or
    query stages + ``keyField``/``window``/``windowSlide``/``agg``."""
    explicit = comp.get("chain")
    if explicit is not None:
        return OperatorChain(list(explicit))
    ops = [] if isinstance(query, IdentityQuery) else query.ops()
    window = float(comp.get("window", 0.0))
    if window > 0:
        lateness = float(comp.get("allowedLateness", 0.0))
        slide = float(comp.get("windowSlide", 0.0))
        ops.append(KeyBy(comp.get("keyField")))
        ops.append(SlidingWindow(window, slide, lateness) if slide > 0
                   else TumblingWindow(window, lateness))
        ops.append(WindowAggregate(comp.get("agg", "count"),
                                   comp.get("valueField")))
    return OperatorChain(ops)


# ---------------------------------------------------------------------------
# Query compat shim: legacy queries as operator chains
# ---------------------------------------------------------------------------


def _unit_of(payload) -> Optional[Any]:
    return (payload.get("unit") if isinstance(payload, dict) else None)


def _data_of(payload) -> Any:
    return (payload["data"] if isinstance(payload, dict)
            and "data" in payload else payload)


def _wrapped(payload: Any, size: int, unit) -> tuple[Any, int]:
    if unit is not None:
        return {"unit": unit, "data": payload}, size
    return payload, size


class Query:
    """Compat shim over an operator chain.

    Subclasses describe themselves as operators (:meth:`ops`); the
    original ``query(spe, eng, records) -> [(payload, size)]`` call
    signature is preserved by running the chain over the batch.
    ``state_attrs`` names instance attributes that belong to the
    checkpointable state (operator-level state lives in the ops).
    """

    measure_wall = False
    state_attrs: tuple = ()

    def __init__(self, comp: Component):
        self.comp = comp
        self._chain: Optional[OperatorChain] = None

    # -- operator-chain surface -----------------------------------------

    def ops(self) -> list:
        """Default: one whole-batch compat stage around :meth:`_run`."""
        return [BatchOp(self._run_elems)]

    @property
    def chain(self) -> OperatorChain:
        if self._chain is None:
            self._chain = OperatorChain(self.ops())
        return self._chain

    def _run_elems(self, elems, ctx) -> list[tuple[Any, int]]:
        return self._run(ctx.runtime, ctx.eng, elems)

    def _run(self, spe, eng, records) -> list[tuple[Any, int]]:
        raise NotImplementedError

    def __call__(self, spe, eng, records) -> list[tuple[Any, int]]:
        ctx = OpContext(eng, spe)
        if isinstance(records, BatchView):
            # columnar ingest: chain fast paths run without Elements;
            # only what leaves the chain is materialized
            cols = ColumnBatch(records.payloads, records.sizes(),
                               records.event_times(), records.keys)
            outs = self.chain.process_cols(cols, ctx)
        else:
            outs = self.chain.process(elements_of(records), ctx)
        return [(e.payload, e.size) for e in outs]

    # -- checkpointable non-operator state -------------------------------

    def attr_snapshot(self) -> dict:
        return {a: copy.deepcopy(getattr(self, a))
                for a in self.state_attrs}

    def attr_restore(self, snap: dict) -> None:
        for a, v in snap.items():
            setattr(self, a, copy.deepcopy(v))

    # legacy helpers (batch-stage bodies still use them)
    @staticmethod
    def _unit(records) -> Optional[Any]:
        for r in reversed(records):
            if isinstance(r.payload, dict) and "unit" in r.payload:
                return r.payload["unit"]
        return None

    @staticmethod
    def _data(r) -> Any:
        return _data_of(r.payload)

    def _wrap(self, payload: Any, size: int, unit) -> tuple[Any, int]:
        return _wrapped(payload, size, unit)


# ---------------------------------------------------------------------------
# Word count pipeline (split -> count) + document analytics
# ---------------------------------------------------------------------------


def _split_fn(payload):
    d = _data_of(payload)
    text = d["text"] if isinstance(d, dict) else str(d)
    words = text.lower().split()
    return _wrapped({"words": words}, max(1, sum(map(len, words))),
                    _unit_of(payload))


class SplitQuery(Query):
    """Document -> list of words (one message per document)."""

    def ops(self):
        return [Map(_split_fn)]


def _count_fn(state, payload):
    totals = state.setdefault("totals", collections.Counter())
    d = _data_of(payload)
    words = d["words"] if isinstance(d, dict) else list(d)
    counts = collections.Counter(words)
    totals.update(counts)
    return _wrapped({"counts": dict(counts),
                     "distinct_total": len(totals)},
                    max(1, 8 * len(counts)), _unit_of(payload))


class CountQuery(Query):
    """Word-frequency counting (stateful across the run)."""

    def ops(self):
        return [StatefulMap(_count_fn)]


def _avg_len_fn(state, payload):
    sums = state.setdefault("sums", collections.Counter())
    ns = state.setdefault("ns", collections.Counter())
    d = _data_of(payload)
    topic = d.get("topic", "default") if isinstance(d, dict) else "default"
    text = d.get("text", "") if isinstance(d, dict) else str(d)
    sums[topic] += len(text.split())
    ns[topic] += 1
    avg = {t: sums[t] / ns[t] for t in sums}
    return _wrapped({"avg_words_per_topic": avg}, 8 * len(avg),
                    _unit_of(payload))


class AvgLenByTopicQuery(Query):
    """Average document length per document-topic (paper Fig. 2a job 2)."""

    def ops(self):
        return [StatefulMap(_avg_len_fn)]


# ---------------------------------------------------------------------------
# Tensor compute of the applications runs on the query's device
# ---------------------------------------------------------------------------


def _device_of(comp):
    """``cuda`` unless the spec says ``device="cpu"``; raises without a
    GPU (never falls back)."""
    from repro_torch.models.params import resolve_device
    return resolve_device(comp.get("device"))


# ---------------------------------------------------------------------------
# Sentiment analysis (lexicon scores, averaged on the device)
# ---------------------------------------------------------------------------

_LEXICON = {
    "good": (0.7, 0.6), "great": (0.8, 0.75), "love": (0.5, 0.6),
    "excellent": (1.0, 1.0), "happy": (0.8, 1.0), "bad": (-0.7, 0.67),
    "terrible": (-1.0, 1.0), "hate": (-0.8, 0.9), "sad": (-0.5, 1.0),
    "awful": (-1.0, 1.0), "okay": (0.2, 0.4), "boring": (-0.4, 0.8),
}


def _sentiment_fn(payload, *, device):
    import torch
    d = _data_of(payload)
    text = d["text"] if isinstance(d, dict) else str(d)
    scores = [_LEXICON[w] for w in text.lower().split() if w in _LEXICON]
    if scores:
        arr = torch.tensor(scores, dtype=torch.float32, device=device)
        pol, subj = arr.mean(dim=0).tolist()
    else:
        pol, subj = 0.0, 0.0
    return _wrapped({"polarity": pol, "subjectivity": subj}, 16,
                    _unit_of(payload))


class SentimentQuery(Query):
    def __init__(self, comp):
        super().__init__(comp)
        self.device = _device_of(comp)

    def ops(self):
        return [Map(functools.partial(_sentiment_fn, device=self.device))]


# ---------------------------------------------------------------------------
# Ride selection (join + groupby + window over structured data)
# ---------------------------------------------------------------------------


class RideSelectQuery(Query):
    """Best tipping areas: groupby(area) of mean tip over the window."""

    def __init__(self, comp):
        super().__init__(comp)
        self.device = _device_of(comp)

    def _run(self, spe, eng, records):
        import torch
        rides = [self._data(r) for r in records]
        rides = [x for x in rides if isinstance(x, dict) and "area" in x]
        if not rides:
            return []
        areas = sorted({x["area"] for x in rides})
        aid = {a: i for i, a in enumerate(areas)}
        dev = self.device
        ids = torch.tensor([aid[x["area"]] for x in rides],
                           dtype=torch.int64, device=dev)
        tips = torch.tensor([float(x.get("tip", 0.0)) for x in rides],
                            dtype=torch.float32, device=dev)
        zeros = torch.zeros(len(areas), dtype=torch.float32, device=dev)
        sums = zeros.clone().index_add_(0, ids, tips)
        ns = zeros.index_add_(0, ids, torch.ones_like(tips))
        means = sums / torch.clamp_min(ns, 1.0)
        best = int(torch.argmax(means))
        means = means.tolist()
        payload = {"best_area": areas[best],
                   "mean_tip": means[best],
                   "areas": {a: means[aid[a]] for a in areas}}
        return [self._wrap(payload, 8 * len(areas), self._unit(records))]


# ---------------------------------------------------------------------------
# Maritime monitoring (windowed count -> external store)
# ---------------------------------------------------------------------------


class MaritimeQuery(Query):
    state_attrs = ("window_id",)

    def __init__(self, comp):
        super().__init__(comp)
        self.ports = set(comp.get("ports", ["halifax", "boston"]))
        self.window_id = 0

    def _run(self, spe, eng, records):
        from repro_torch.core import store as store_mod
        reports = [self._data(r) for r in records]
        counts = collections.Counter(
            x["port"] for x in reports
            if isinstance(x, dict) and x.get("port") in self.ports)
        self.window_id += 1
        store_name = self.comp.get("store")
        if store_name:
            st = store_mod.lookup(store_name)
            st.remote_put(eng, spe.host, f"window{self.window_id}",
                          dict(counts))
        return [self._wrap({"window": self.window_id,
                            "counts": dict(counts)}, 8 * len(counts),
                           self._unit(records))]


# ---------------------------------------------------------------------------
# Fraud detection (linear SVM trained at init; inference on the device)
# ---------------------------------------------------------------------------


def _svm_grad(w, X, y):
    """Gradient of ``mean(max(1 - y * (X[:, :-1] @ w[:-1] + w[-1]), 0))
    + 1e-3 * w @ w`` in closed form.  At a zero margin the hinge's slope
    is 1/2, the subgradient ``jax.grad`` gives ``jnp.maximum`` at a tie."""
    import torch
    margins = 1.0 - y * (X[:, :-1] @ w[:-1] + w[-1])
    slope = torch.where(margins > 0, 1.0,
                        torch.where(margins == 0, 0.5, 0.0))
    # d loss / d (X[:, :-1] @ w[:-1] + w[-1])
    ct = -(slope / X.shape[0]) * y
    g = torch.cat([X[:, :-1].T @ ct, ct.sum()[None]])
    return g + 2e-3 * w


class FraudSVMQuery(Query):
    def __init__(self, comp):
        super().__init__(comp)
        import torch
        self.device = dev = _device_of(comp)
        dim = int(comp.get("dim", 8))
        rng = np.random.default_rng(0)
        # synthetic training set: anomalies have shifted mean
        n = 256
        x0 = rng.normal(0.0, 1.0, (n, dim))
        x1 = rng.normal(2.5, 1.0, (n, dim))
        X = torch.tensor(np.concatenate([x0, x1]), dtype=torch.float32,
                         device=dev)
        y = torch.tensor([-1.0] * n + [1.0] * n, dtype=torch.float32,
                         device=dev)
        w = torch.zeros((dim,), dtype=torch.float32, device=dev)
        for _ in range(200):
            w = w - 0.1 * _svm_grad(w, X, y)
        self.w = w
        self.dim = dim

    def _run(self, spe, eng, records):
        import torch
        feats = []
        for r in records:
            d = self._data(r)
            if isinstance(d, dict) and "x" in d:
                feats.append(np.asarray(d["x"], np.float32))
        if not feats:
            return []
        # bucket-pad rows as the reference does for its jit (scores are
        # per-row, so padding rows cannot perturb real rows)
        n = len(feats)
        xs = np.zeros((jit_bucket(n), self.dim), np.float32)
        xs[:n] = np.stack(feats)
        xt = torch.from_numpy(xs).to(self.device)
        scores = (xt[:, :-1] @ self.w[:-1] + self.w[-1]).cpu().numpy()[:n]
        payload = {"n": n,
                   "anomalies": int((scores > 0).sum()),
                   "scores": scores.tolist()}
        return [self._wrap(payload, 4 * n, self._unit(records))]


# ---------------------------------------------------------------------------
# Ocampo traffic monitoring (measured-wall query)
# ---------------------------------------------------------------------------


class TrafficMetricsQuery(Query):
    """Connections and bandwidth per service over the window.  The
    reference also sorts the sizes for a top-8 it never emits; that sort
    is left out."""

    measure_wall = True

    def __init__(self, comp):
        super().__init__(comp)
        self.services = list(comp.get(
            "services", ["ftp", "web", "dns", "mail"]))
        self._sid = {s: i for i, s in enumerate(self.services)}
        self.device = _device_of(comp)

    def _run(self, spe, eng, records):
        import torch
        pkts = [self._data(r) for r in records]
        pkts = [p for p in pkts if isinstance(p, dict) and "service" in p]
        if not pkts:
            return []
        n = jit_bucket(len(pkts))                        # pad: stable shapes
        sids = np.zeros((n,), np.int64)
        sizes = np.zeros((n,), np.float32)
        valid = np.zeros((n,), bool)
        for i, p in enumerate(pkts):
            sids[i] = self._sid.get(p["service"], 0)
            sizes[i] = float(p.get("bytes", 0))
            valid[i] = True
        dev = self.device
        sids_t = torch.from_numpy(sids).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        ones = torch.where(valid_t, 1.0, 0.0)
        szs = torch.where(valid_t, torch.from_numpy(sizes).to(dev), 0.0)
        zeros = torch.zeros(len(self.services), dtype=torch.float32,
                            device=dev)
        conns = zeros.clone().index_add_(0, sids_t, ones)
        bw = zeros.index_add_(0, sids_t, szs)
        conns, bw = torch.stack([conns, bw]).tolist()   # read back
        payload = {
            "connections": {s: conns[i] for s, i in self._sid.items()},
            "bandwidth": {s: bw[i] for s, i in self._sid.items()},
        }
        return [self._wrap(payload, 8 * len(self.services),
                           self._unit(records))]


# ---------------------------------------------------------------------------
# LM serving job (real model decode over the stream)
# ---------------------------------------------------------------------------


class LMGenerateQuery(Query):
    """Greedy LM generation over token batches (prefill, then decode).

    Component attributes: ``arch`` (default ``xlstm-125m``, as in the
    reference), ``genTokens``, ``maxLen``, ``device`` (default ``cuda``)
    and ``smoke`` (default ``True``: the reference's
    ``reduce_for_smoke`` config; ``False`` runs ``get_config(arch)`` at
    full width).  Parameters come from :meth:`_init_params`, which tests
    override to load the reference's values.
    """

    def __init__(self, comp):
        super().__init__(comp)
        self._built = False

    def _build(self):
        from repro_torch.configs import get_config, reduce_for_smoke
        from repro_torch.models import Model

        arch = self.comp.get("arch", "xlstm-125m")
        cfg = get_config(arch)
        if self.comp.get("smoke", True):
            cfg = reduce_for_smoke(cfg)
        self.cfg = cfg
        self.model = Model(cfg, device=self.comp.get("device"))
        self._init_params(self.model)
        self.gen_tokens = int(self.comp.get("genTokens", 8))
        self.max_len = int(self.comp.get("maxLen", 128))
        self._built = True

    def _init_params(self, model) -> None:
        import torch
        model.init_params(torch.Generator(device=model.device).manual_seed(0))

    def generate(self, tokens):
        """tokens: (B, S) int tensor on the model's device -> (B, gen)."""
        import torch
        model = self.model
        B, S = tokens.shape
        logits, cache = model.prefill(tokens)
        # right-size the cache into the decode layout
        full = model.init_cache(B, self.max_len, torch.float32)
        cache = _merge_prefill_cache(full, cache, S)
        tok = torch.argmax(logits[:, -1], -1)
        out = [tok]
        # the reference scans genTokens decode steps and drops the last
        # step's token (spe.py:875); that step changes no output, so
        # genTokens - 1 steps are run here
        for i in range(self.gen_tokens - 1):
            lg, cache = model.decode_step(cache, tok[:, None], S + i)
            tok = torch.argmax(lg[:, -1], -1)
            out.append(tok)
        return torch.stack(out, 1)

    def _run(self, spe, eng, records):
        if not self._built:
            self._build()
        import torch
        out = []
        for r in records:
            d = self._data(r)
            if not (isinstance(d, dict) and "tokens" in d):
                continue
            toks = np.asarray(d["tokens"]) % self.cfg.vocab_size
            # bucket-pad the batch axis: rows decode independently, so
            # padded requests change no outputs
            B = toks.shape[0]
            Bp = jit_bucket(B, min_bucket=1)
            if Bp != B:
                toks = np.concatenate(
                    [toks, np.zeros((Bp - B, toks.shape[1]), toks.dtype)], 0)
            t = torch.as_tensor(toks, dtype=torch.int64,
                                device=self.model.device)
            gen = self.generate(t).cpu().numpy()[:B]
            unit = _unit_of(r.payload)
            out.append(self._wrap({"generated": gen.tolist()},
                                  int(gen.size * 4), unit))
        return out


def _merge_prefill_cache(full, prefill, S: int):
    """Write prefill KV (length S) into a max_len cache; pass states thru.

    Generic splice: whichever single axis differs between the prefill
    tensor and the max-length cache is the sequence axis; the prefill
    content lands at offset 0 there.  Writes into ``full`` in place and
    returns it.
    """
    if isinstance(full, dict):
        for k in full:
            full[k] = _merge_prefill_cache(full[k], prefill[k], S)
        return full
    if isinstance(full, list):
        return [_merge_prefill_cache(f, p, S) for f, p in zip(full, prefill)]
    dst, src = full, prefill
    if dst.shape == src.shape:
        dst.copy_(src)
        return dst
    assert dst.dim() == src.dim(), (dst.shape, src.shape)
    diff = [i for i in range(dst.dim()) if dst.shape[i] != src.shape[i]]
    assert len(diff) == 1, (dst.shape, src.shape)
    dst.narrow(diff[0], 0, src.shape[diff[0]]).copy_(src)
    return dst


class LMTrainQuery(Query):
    """Real LM training as a stream job: batches in, loss metrics out.

    Component attributes: ``arch`` (default ``xlstm-125m``), ``seed``,
    ``device`` (default ``cuda``) and ``smoke`` (default ``True``: the
    reference's ``reduce_for_smoke`` config; ``False`` trains
    ``get_config(arch)`` at full width).  The train state comes from
    :meth:`_init_params` at the first batch, whose shape it takes.
    Training state is a real optimizer state on the device — deliberately
    outside ``state_attrs`` (checkpointing model weights is the job of
    ``repro_torch.checkpoint``, not the stream-state backend).
    """

    def __init__(self, comp):
        super().__init__(comp)
        self._built = False

    def _build(self):
        from repro_torch.configs import get_config, reduce_for_smoke
        from repro_torch.models.params import resolve_device

        cfg = get_config(self.comp.get("arch", "xlstm-125m"))
        if self.comp.get("smoke", True):
            cfg = reduce_for_smoke(cfg)
        self.cfg = cfg
        self.device = resolve_device(self.comp.get("device"))
        self._bundle = None
        self._state = None
        self._seed = int(self.comp.get("seed", 0))
        self._built = True

    def _init_params(self, bundle) -> dict:
        import torch
        return bundle.init_fn(
            torch.Generator(device=self.device).manual_seed(self._seed))

    def _run(self, spe, eng, records):
        if not self._built:
            self._build()
        import torch
        from repro_torch.configs.base import ShapeCfg
        from repro_torch.train import make_step_bundle
        out = []
        for r in records:
            d = self._data(r)
            if not (isinstance(d, dict) and "tokens" in d):
                continue
            toks = torch.as_tensor(
                np.asarray(d["tokens"]) % self.cfg.vocab_size,
                dtype=torch.int64, device=self.device)
            B, S = toks.shape
            if self._bundle is None:
                self._bundle = make_step_bundle(
                    self.cfg, ShapeCfg("gym", S, B, "train"))
                self._state = self._init_params(self._bundle)
            batch = {"inputs": toks[:, :-1] if S > 1 else toks,
                     "labels": toks[:, 1:] if S > 1 else toks}
            self._state, metrics = self._bundle.step_fn(self._state, batch)
            unit = _unit_of(r.payload)
            out.append(self._wrap(
                {"loss": float(metrics["loss"]),
                 "step": int(metrics["step"])}, 16, unit))
        return out


class IdentityQuery(Query):
    def ops(self):
        return []                    # empty chain: pure passthrough

    def __call__(self, spe, eng, records):
        if isinstance(records, BatchView):
            # pure passthrough needs neither Records nor Elements
            return list(zip(records.payloads, records.sizes()))
        return [(e.payload, e.size) for e in elements_of(records)]


QUERIES: dict[str, type[Query]] = {
    "split": SplitQuery,
    "count": CountQuery,
    "avg_len_by_topic": AvgLenByTopicQuery,
    "sentiment": SentimentQuery,
    "ride_select": RideSelectQuery,
    "maritime": MaritimeQuery,
    "fraud_svm": FraudSVMQuery,
    "traffic_metrics": TrafficMetricsQuery,
    "lm_generate": LMGenerateQuery,
    "lm_train": LMTrainQuery,
    "identity": IdentityQuery,
}

def query_class(name: str) -> type[Query]:
    return QUERIES[name]
