"""Monitoring: event logs, message latency, delivery matrix, throughput.

Mirrors the paper's monitoring module: per-port (here per-host) throughput
counters sampled over time bins, timestamped application events, message
latency at subscribers, and the Fig. 6b delivery matrix.
"""
from __future__ import annotations

import collections
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.telemetry import LatencyHistogram


@dataclass
class MsgStat:
    msg_id: int
    topic: str
    producer: str
    size: int
    produce_time: float
    partition: int = 0
    ack_time: Optional[float] = None
    expired_time: Optional[float] = None
    truncated_time: Optional[float] = None
    deliveries: dict[str, float] = field(default_factory=dict)


class Monitor:
    def __init__(self, *, throughput_bin: float = 1.0) -> None:
        self.msgs: dict[int, MsgStat] = {}
        self.events: list[dict] = []
        self.bin = throughput_bin
        # host -> {bin_index -> bytes}
        self.tx: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter)
        self.rx: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter)
        self._now = lambda: 0.0     # set by the engine
        # bounded store behind Engine.metrics()'s latency_* fields:
        # first-time deliveries land here instead of an unbounded raw
        # list (fixed bins, vectorized per fetch response)
        self.delivery_hist = LatencyHistogram()
        # observability hooks; the engine attaches its Telemetry when
        # the spec enables it (None = off, zero overhead)
        self.telemetry = None

    def bind_clock(self, now_fn) -> None:
        self._now = now_fn

    # --- message lifecycle -------------------------------------------------

    def produced(self, rec) -> None:
        self.msgs[rec.msg_id] = MsgStat(
            rec.msg_id, rec.topic, rec.producer, rec.size, rec.produce_time,
            getattr(rec, "partition", 0))
        tel = self.telemetry
        if tel is not None:
            tel.lineage_produce(rec.msg_id, rec.topic, rec.produce_time)
            tel.flight(rec.produce_time, "produce",
                       topic=rec.topic, producer=rec.producer,
                       msg_id=rec.msg_id, size=rec.size)

    def committed(self, rec, t: float) -> None:
        self.msgs[rec.msg_id].ack_time = t

    def expired(self, rec, t: float) -> None:
        self.msgs[rec.msg_id].expired_time = t
        self.event(t, "msg_expired", msg_id=rec.msg_id, topic=rec.topic)

    def truncated(self, rec, t: float) -> None:
        self.msgs[rec.msg_id].truncated_time = t
        self.event(t, "msg_truncated", msg_id=rec.msg_id, topic=rec.topic)

    def delivered(self, rec, consumer: str, t: float) -> None:
        self.delivered_many((rec.msg_id,), consumer, t)

    def delivered_many(self, msg_ids, consumer: str, t: float) -> None:
        """Batched delivery tally (the columnar fetch path: one call per
        response, no per-row Record objects).

        First-time deliveries feed the bounded latency histogram (and,
        when telemetry is on, per-partition rate counters + a flight
        marker); re-deliveries keep the original timestamp, matching the
        old ``setdefault`` semantics.
        """
        msgs = self.msgs
        tel = self.telemetry
        lats = []
        for mid in msg_ids:
            m = msgs[mid]
            if consumer not in m.deliveries:
                m.deliveries[consumer] = t
                lats.append(t - m.produce_time)
                if tel is not None:
                    tel.count_delivery(m.topic, m.partition, m.size)
        if lats:
            self.delivery_hist.add_many(lats)
            if tel is not None:
                tel.flight(t, "deliver", consumer=consumer, n=len(lats))

    # --- network counters --------------------------------------------------

    def broker_tx(self, host: str, nbytes: int) -> None:
        self.tx[host][int(self._now() / self.bin)] += nbytes

    def broker_rx(self, host: str, nbytes: int) -> None:
        self.rx[host][int(self._now() / self.bin)] += nbytes

    # --- generic events ------------------------------------------------------

    def event(self, t: float, kind: str, **kw) -> None:
        self.events.append({"t": t, "kind": kind, **kw})
        tel = self.telemetry
        if tel is not None:
            tel.flight(t, kind, **kw)

    def events_of(self, kind: str) -> list[dict]:
        return [e for e in self.events if e["kind"] == kind]

    # --- reports ------------------------------------------------------------

    def delivery_matrix(self, consumers: list[str], *,
                        producer: Optional[str] = None,
                        topic: Optional[str] = None
                        ) -> tuple[list[int], list[list[bool]]]:
        """Rows = consumers, cols = messages (by produce order)."""
        msgs = sorted(
            (m for m in self.msgs.values()
             if (producer is None or producer in m.producer)
             and (topic is None or m.topic == topic)),
            key=lambda m: m.produce_time)
        ids = [m.msg_id for m in msgs]
        matrix = [[c in m.deliveries for m in msgs] for c in consumers]
        return ids, matrix

    def latencies(self, *, topic: Optional[str] = None,
                  consumer: Optional[str] = None) -> list[tuple[float, float]]:
        """(receive_time, latency_s) per delivery, receive-time ordered."""
        out = []
        for m in self.msgs.values():
            if topic is not None and m.topic != topic:
                continue
            for c, t in m.deliveries.items():
                if consumer is None or c == consumer:
                    out.append((t, t - m.produce_time))
        return sorted(out)

    def throughput_series(self, host: str, *, direction: str = "tx"
                          ) -> list[tuple[float, float]]:
        """(bin_start_s, bytes/s) samples for one host."""
        ctr = (self.tx if direction == "tx" else self.rx)[host]
        if not ctr:
            return []
        hi = max(ctr)
        return [(i * self.bin, ctr.get(i, 0) / self.bin)
                for i in range(0, hi + 1)]

    def loss_report(self, consumers: list[str]) -> dict:
        total = len(self.msgs)
        lost_ids = [m.msg_id for m in self.msgs.values()
                    if len(m.deliveries) < len(consumers)]
        fully = total - len(lost_ids)
        return {
            "total": total,
            "fully_delivered": fully,
            "lost_or_partial": len(lost_ids),
            "expired": sum(1 for m in self.msgs.values()
                           if m.expired_time is not None),
            "truncated": sum(1 for m in self.msgs.values()
                             if m.truncated_time is not None),
            "lost_ids": lost_ids,
        }

    def e2e_latency(self, *, unit_key: str = "unit") -> list[float]:
        """End-to-end pipeline latencies recorded via paired events.

        Components emit ``unit_in``/``unit_out`` events carrying a shared
        ``unit`` id; the e2e latency of a data unit is last-out minus
        first-in (paper Fig. 5 measures a text file through the pipeline).
        """
        first_in: dict[Any, float] = {}
        last_out: dict[Any, float] = {}
        for e in self.events:
            if e["kind"] == "unit_in":
                first_in.setdefault(e[unit_key], e["t"])
            elif e["kind"] == "unit_out":
                last_out[e[unit_key]] = e["t"]
        return [last_out[u] - first_in[u]
                for u in last_out if u in first_in]

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "events": self.events,
                "n_msgs": len(self.msgs),
            }, f, indent=2, default=str)
