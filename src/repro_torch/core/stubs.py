"""Producer/consumer stub repository (paper §III-B).

Producer types:
  SFST       — stream each line of a file as a data element (paper Fig. 4)
  DIRECTORY  — stream each file in a directory as a data element
  SYNTHETIC  — random payloads at a target rate (Fig. 6: 30 Kbps, 2 topics)
  FRAMES     — burst-produce N image frames up-front (Ichinose repro)
  PACKET     — Poisson per-user packet traffic to services (Ocampo repro)
  TOKENS     — LM token batches (numpy arrays) for model pipelines

Consumer types:
  STANDARD   — poll, process (per-byte host cost), record unit completions
  METRICS    — STANDARD + retains payloads for assertions
  COUNTING   — STANDARD + byte/message counters (Ichinose throughput)
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from repro_torch.core.broker import BatchView, payloads_of
from repro_torch.core.spec import Component
from repro_torch.core.subscription import DeliveryLoop

# Host-compute cost model (seconds); deliberately simple + documented.
PER_RECORD_S = 50e-6
PER_BYTE_S = 2e-9


# ---------------------------------------------------------------------------
# Producers
# ---------------------------------------------------------------------------


class ProducerBase:
    def __init__(self, comp: Component, host: str):
        self.comp = comp
        self.host = host
        self.name = comp.name
        self.topic = comp.get("topicName") or comp.get("topic")
        self.sent = 0
        # produce batching (Kafka linger.ms / batch.size) + keyed routing
        self.linger_s = float(comp.get("lingerMs", 0.0)) / 1e3
        self.batch_bytes = int(comp.get("batchBytes", 1 << 14))
        # nKeys > 0: cycle a deterministic key space (no RNG draw, so
        # keyed runs stay bit-comparable with unkeyed ones elsewhere)
        self.n_keys = int(comp.get("nKeys", 0))
        # event-time stamping: etJitterS > 0 backdates each record's
        # event_time by uniform(0, etJitterS) seconds — the out-of-order
        # arrival model that exercises late-record handling downstream.
        # Draws come from a dedicated RNG stream, so enabling jitter
        # never perturbs the producer's schedule stream (and 0 draws
        # nothing: runs without jitter stay bit-identical).
        self.et_jitter_s = float(comp.get("etJitterS", 0.0))
        self._et_rng = None

    def start(self, eng) -> None:
        # own deterministic stream: producer schedules are independent of
        # consumer-side draws (poll/wakeup parity, see engine.client_rng)
        self.rng = eng.client_rng(self.name)
        eng.schedule(float(self.comp.get("startDelay", 0.0)),
                     lambda: self.tick(eng))

    def tick(self, eng) -> None:
        raise NotImplementedError

    def produce(self, eng, payload: Any, size: int,
                topic: Optional[str] = None,
                unit: Optional[Any] = None,
                key: Optional[Any] = None,
                event_time: Optional[float] = None) -> None:
        if unit is not None:
            eng.monitor.event(eng.now, "unit_in", unit=unit)
            payload = {"unit": unit, "data": payload}
        if key is None and self.n_keys:
            key = f"{self.name}/k{self.sent % self.n_keys}"
        if event_time is None and self.et_jitter_s > 0:
            if self._et_rng is None:
                self._et_rng = eng.client_rng(f"{self.name}/et")
            event_time = max(
                0.0, eng.now - self._et_rng.uniform(0, self.et_jitter_s))
        eng.cluster.produce(self.host, self.name, topic or self.topic,
                            payload, size, key=key,
                            linger_s=self.linger_s,
                            batch_bytes=self.batch_bytes,
                            event_time=event_time)
        self.sent += 1


class SFSTProducer(ProducerBase):
    """Single-file stream: one message per line, fixed interval."""

    def start(self, eng) -> None:
        path = self.comp.get("filePath")
        if path and os.path.exists(path):
            with open(path) as f:
                self.lines = f.read().splitlines()
        else:
            self.lines = list(self.comp.get("lines", []))
        self.total = int(self.comp.get("totalMessages", len(self.lines)))
        self.interval = float(self.comp.get("interval", 0.1))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.total or not self.lines:
            return
        line = self.lines[self.sent % len(self.lines)]
        self.produce(eng, line, max(1, len(line)))
        eng.schedule(self.interval, lambda: self.tick(eng))


class DirectoryProducer(ProducerBase):
    """One message per file; unit = file id (paper's e2e data unit)."""

    def start(self, eng) -> None:
        path = self.comp.get("dirPath")
        if path and os.path.isdir(path):
            self.files = []
            for fn in sorted(os.listdir(path)):
                with open(os.path.join(path, fn)) as f:
                    self.files.append((fn, f.read()))
        else:
            self.files = [(f"doc{i}", txt)
                          for i, txt in enumerate(self.comp.get("docs", []))]
        self.total = int(self.comp.get("totalMessages", len(self.files)))
        self.interval = float(self.comp.get("interval", 0.1))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.total or not self.files:
            return
        fn, txt = self.files[self.sent % len(self.files)]
        unit = f"{self.name}:{self.sent}"
        self.produce(eng, {"file": fn, "text": txt}, max(1, len(txt)),
                     unit=unit)
        eng.schedule(self.interval, lambda: self.tick(eng))


class SyntheticProducer(ProducerBase):
    """Random payloads at rate_kbps split round-robin/randomly over topics."""

    def start(self, eng) -> None:
        self.topics = self.comp.get("topics") or [self.topic]
        self.msg_size = int(self.comp.get("msgSize", 512))
        rate_kbps = float(self.comp.get("rateKbps", 30.0))
        self.interval = self.msg_size * 8.0 / (rate_kbps * 1e3)
        self.total = int(self.comp.get("totalMessages", 10**9))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.total:
            return
        topic = self.topics[self.rng.randrange(len(self.topics))]
        payload = {"seq": self.sent, "src": self.name}
        self.produce(eng, payload, self.msg_size, topic=topic)
        eng.schedule(self.interval, lambda: self.tick(eng))


class FramesProducer(ProducerBase):
    """Ichinose-style: produce `count` frames as fast as possible at t=0."""

    def start(self, eng) -> None:
        self.count = int(self.comp.get("count", 1000))
        self.frame_bytes = int(self.comp.get("frameBytes", 28 * 28))
        self.burst_interval = float(self.comp.get("burstInterval", 1e-4))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.count:
            return
        frame = np.zeros((1,), np.uint8)  # stand-in; size modeled explicitly
        self.produce(eng, {"frame": frame, "i": self.sent}, self.frame_bytes)
        eng.schedule(self.burst_interval, lambda: self.tick(eng))


class PacketProducer(ProducerBase):
    """Ocampo-style network user: Poisson packets to a set of services."""

    def start(self, eng) -> None:
        self.services = list(self.comp.get(
            "services", ["ftp", "web", "dns", "mail"]))
        self.rate_pps = float(self.comp.get("ratePps", 20.0))
        self.pkt_bytes = int(self.comp.get("pktBytes", 256))
        self.total = int(self.comp.get("totalMessages", 10**9))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.total:
            return
        svc = self.services[self.rng.randrange(len(self.services))]
        self.produce(eng, {"user": self.name, "service": svc,
                           "bytes": self.pkt_bytes}, self.pkt_bytes)
        eng.schedule(self.rng.expovariate(self.rate_pps),
                     lambda: self.tick(eng))


class TokensProducer(ProducerBase):
    """LM request batches: (batch, seq) int32 token arrays."""

    def start(self, eng) -> None:
        self.batch = int(self.comp.get("batch", 4))
        self.seq_len = int(self.comp.get("seqLen", 32))
        self.vocab = int(self.comp.get("vocab", 512))
        self.interval = float(self.comp.get("interval", 1.0))
        self.total = int(self.comp.get("totalMessages", 16))
        self._rng = np.random.default_rng(int(self.comp.get("seed", 0)))
        super().start(eng)

    def tick(self, eng) -> None:
        if self.sent >= self.total:
            return
        toks = self._rng.integers(
            0, self.vocab, (self.batch, self.seq_len), dtype=np.int32)
        unit = f"req:{self.name}:{self.sent}"
        self.produce(eng, {"tokens": toks}, toks.nbytes, unit=unit)
        eng.schedule(self.interval, lambda: self.tick(eng))


# ---------------------------------------------------------------------------
# Consumers
# ---------------------------------------------------------------------------


class ConsumerBase(DeliveryLoop):
    def __init__(self, comp: Component, host: str):
        t = comp.get("topics") or comp.get("topic") or comp.get("topicName")
        # shared subscriber surface (name/group/poll cadence/busy gate)
        # lives on DeliveryLoop — see core/subscription.py
        self.init_subscriber(
            comp, host, [t] if isinstance(t, str) else list(t or []))
        self.per_record_cost = float(comp.get("perRecordCost", 0.0))
        self.n_received = 0
        self.bytes_received = 0

    def start(self, eng) -> None:
        self.start_delivery(eng, self.topics)

    def on_records(self, eng, records) -> None:
        # fused deliver cohorts arrive through the DeliveryLoop default
        # on_records_cohort (per-view calls in landing order): each view
        # must chain busy_until through its own _done event so the sink
        # spans fire at per-view completion times — merging views into
        # one execute_on would change the sink histograms and break the
        # fused/legacy parity contract (ROADMAP cohort contract).
        #
        # load shedding happens at admission (offsets already advanced,
        # so shed rows are consumed-but-dropped, never replayed); a
        # no-op for the default unbounded / pause configurations
        if self.queue_bytes_max > 0:
            records = self.bp_admit(eng, records)
        # columnar fast path: O(1) byte accounting off the prefix sums,
        # payload-pointer access only — no Record materialization
        if isinstance(records, BatchView):
            nbytes = records.total_bytes()
        else:
            nbytes = sum(r.size for r in records)
        k = len(records)
        if self.queue_bytes_max > 0 and not k:
            return      # whole batch shed
        self.n_received += k
        self.bytes_received += nbytes
        cost = (PER_RECORD_S + self.per_record_cost) * k \
            + PER_BYTE_S * nbytes
        ep = self._bp_epoch

        def _done():
            for p in payloads_of(records):
                if isinstance(p, dict) and "unit" in p:
                    eng.monitor.event(eng.now, "unit_out", unit=p["unit"])
            tel = eng.telemetry
            if tel is not None and isinstance(records, BatchView):
                # sink span: produce → consumer processing complete
                # (one vectorized insert off the columnar slice)
                tel.span_many("sink", records.topic,
                              eng.now - records.produce_time)
                if tel._lineage:
                    tel.lineage_mark(records.msg_ids(), "sink", eng.now)
            elif tel is not None and records:
                tel.span_many(
                    "sink", records[0].topic,
                    [eng.now - r.produce_time for r in records])
                if tel._lineage:
                    tel.lineage_mark([r.msg_id for r in records],
                                     "sink", eng.now)
            self.handle(eng, records)
            if self.queue_bytes_max > 0:
                self.bp_drain(eng, nbytes, ep)

        self.busy_until = eng.execute_on(self.host, cost, _done)

    def handle(self, eng, records) -> None:
        pass


class StandardConsumer(ConsumerBase):
    pass


class MetricsConsumer(ConsumerBase):
    def __init__(self, comp: Component, host: str):
        super().__init__(comp, host)
        self.payloads: list = []

    def handle(self, eng, records) -> None:
        self.payloads.extend(payloads_of(records))


class CountingConsumer(ConsumerBase):
    """Tracks a (time, cumulative_bytes) series for throughput curves."""

    def __init__(self, comp: Component, host: str):
        super().__init__(comp, host)
        self.series: list[tuple[float, int]] = []

    def handle(self, eng, records) -> None:
        self.series.append((eng.now, self.bytes_received))


_PRODUCERS = {
    "SFST": SFSTProducer,
    "DIRECTORY": DirectoryProducer,
    "SYNTHETIC": SyntheticProducer,
    "FRAMES": FramesProducer,
    "PACKET": PacketProducer,
    "TOKENS": TokensProducer,
}

_CONSUMERS = {
    "STANDARD": StandardConsumer,
    "METRICS": MetricsConsumer,
    "COUNTING": CountingConsumer,
}


def make_producer(comp: Component, host: str):
    return _PRODUCERS[comp.type](comp, host)


def make_consumer(comp: Component, host: str):
    return _CONSUMERS[comp.type](comp, host)
