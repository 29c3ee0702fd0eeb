"""PipelineSpec — the paper's high-level modeling interface (Table I).

A stream processing pipeline is a graph: hosts carry components (producers,
consumers, brokers, stream processing engines, stores), links carry network
attributes, and graph-level attributes configure topics and faults.  Specs
can be loaded from GraphML + YAML exactly as in the paper (Fig. 3/4) or
built programmatically (the tests' and examples' preferred path).

Supported attributes mirror the paper's Table I:

graph:  topicCfg, faultCfg, chaosCfg (seed-expanded fault plans),
        telemetryCfg (observability: sampling interval, lineage, profiler)
node:   prodType/prodCfg, consType/consCfg, streamProcType/streamProcCfg,
        storeType/storeCfg, brokerCfg, cpuPercentage
link:   lat (ms), bw (Mbps), loss (%), st, dt (ports)

Stream-processor (``streamProcCfg``) knobs for the operator-graph SPE
(validated here, consumed by ``core/spe.py``):

timeMode            "processing" (legacy, default) | "event" (watermarks)
window              window size, seconds (0 = unwindowed)
windowSlide         sliding-window slide, seconds (0 = tumbling)
allowedLateness     event-time lateness bound, seconds
checkpointInterval  operator-state checkpoint cadence, seconds (0 = off)
semantics           "at_least_once" (default) | "exactly_once"
keyField / agg / valueField
                    event-time windowing: key extractor field, aggregate
                    name (count|sum|mean), numeric value field

Broker (``brokerCfg``) additions: ``fetch_min_bytes`` /
``fetch_max_wait_s`` — consumer-side fetch lingering, symmetric to the
producer's ``lingerMs``/``batchBytes`` (defaults disable it).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import networkx as nx
import yaml

from repro_torch.core.netem import LinkCfg, Network
from repro_torch.core.telemetry import TelemetryCfg

# component roles
PRODUCER = "producer"
CONSUMER = "consumer"
BROKER = "broker"
SPE = "spe"
STORE = "store"

_ROLES = (PRODUCER, CONSUMER, BROKER, SPE, STORE)


@dataclass
class Component:
    role: str                      # one of _ROLES
    type: str = "STANDARD"         # e.g. SFST / DIRECTORY / SPARK / MYSQL
    cfg: dict[str, Any] = field(default_factory=dict)
    name: str = ""                 # unique id, assigned by the spec

    def get(self, key: str, default=None):
        return self.cfg.get(key, default)


@dataclass
class TopicCfg:
    name: str
    leader: Optional[str] = None    # preferred leader of partition 0
    replication: int = 1
    partitions: int = 1             # per-partition leaders rotate from
                                    # ``leader`` over the broker list


@dataclass
class FaultCfg:
    """One fault event (Table I ``faultCfg``)."""

    at: float                       # seconds into the run
    kind: str                       # link_down | host_down | gray_loss
                                    # | slow_host
    target: tuple[str, ...]         # (a, b) for links, (host,) for hosts
    duration: float = 0.0           # 0 = permanent
    loss_pct: float = 0.0           # for gray_loss
    delay_s: float = 0.0            # for slow_host (extra transfer delay)


FAULT_KINDS = ("link_down", "host_down", "gray_loss", "slow_host")


@dataclass
class ChaosCfg:
    """A seed-expanded adversarial fault plan.

    Instead of hand-placing individual :class:`FaultCfg` entries, a chaos
    plan names *how much* adversity to inject over a time window;
    ``core/faults.py`` expands it into a concrete fault schedule drawn
    from the dedicated ``Engine.client_rng("chaos")`` stream at install
    time.  The expansion draws in a fixed category order (flapping →
    correlated → gray → slow → crash) over sorted candidate lists, so a
    single (spec, seed) pair names an entire adversarial run
    bit-identically across processes, schedulers and delivery modes.

    Categories (each ``0`` = disabled, the default — a default plan
    expands to nothing and perturbs no RNG stream):

    flap_links    links that flap down/up on a duty cycle for the whole
                  window (``flap_period_s`` × ``flap_duty`` down-time)
    correlated    events taking ALL links of one host down at once —
                  rack/tier failures; access-tier (non-core) hosts are
                  preferred when the topology carries a ``geo_wan``
                  core/access split (``PipelineSpec.core_hosts``)
    gray          gray-degradation ramps: ``gray_steps`` overlapping
                  ``gray_loss`` faults stepping up to
                  ``gray_max_loss_pct`` on one link
    slow          slow-host (degraded ack) episodes: ``slow_delay_s``
                  extra transfer delay on every path touching the host
    crashes       host crash/heal cycles (``crash_downtime_s`` outage)

    ``protect`` names hosts never crashed or slowed (e.g. brokers when
    only edge adversity is wanted).
    """

    start: float = 0.0
    duration: float = 0.0           # plan window; > 0 when any count set
    flap_links: int = 0
    flap_period_s: float = 4.0
    flap_duty: float = 0.5          # fraction of each period spent down
    correlated: int = 0
    correlated_duration_s: float = 2.0
    gray: int = 0
    gray_max_loss_pct: float = 40.0
    gray_steps: int = 3
    gray_step_s: float = 2.0
    slow: int = 0
    slow_delay_s: float = 0.05
    slow_duration_s: float = 4.0
    crashes: int = 0
    crash_downtime_s: float = 2.0
    protect: tuple = ()

    def counts(self) -> tuple[int, ...]:
        return (self.flap_links, self.correlated, self.gray, self.slow,
                self.crashes)


@dataclass
class HostSpec:
    name: str
    components: list[Component] = field(default_factory=list)
    cpu_percentage: float = 100.0   # Table I cpuPercentage
    n_cores: int = 8                # emulated host core count

    def by_role(self, role: str) -> list[Component]:
        return [c for c in self.components if c.role == role]


class PipelineSpec:
    """The full emulation task description."""

    def __init__(self, *, mode: str = "zk",
                 delivery: str = "wakeup", columnar: bool = True,
                 scheduler: str = "calendar",
                 fetch_mode: str = "fused") -> None:
        assert mode in ("zk", "kraft"), mode
        assert delivery in ("wakeup", "poll"), delivery
        assert scheduler in ("calendar", "heap"), scheduler
        assert fetch_mode in ("fused", "legacy"), fetch_mode
        self.hosts: dict[str, HostSpec] = {}
        self.topics: dict[str, TopicCfg] = {}
        self.faults: list[FaultCfg] = []
        # seed-expanded adversarial plan (None = no chaos; see ChaosCfg)
        self.chaos: Optional[ChaosCfg] = None
        # observability knobs (None = telemetry off, zero added events;
        # see core/telemetry.py and the ROADMAP telemetry contract)
        self.telemetry: Optional[TelemetryCfg] = None
        # core-tier site names carried from a geo_wan topology's
        # core/access split (empty otherwise) — chaos correlated
        # failures prefer access-tier hosts
        self.core_hosts: list[str] = []
        self.network = Network()
        self.mode = mode            # broker coordination: ZooKeeper vs KRaft
        # subscriber delivery: "wakeup" (event-driven, the fast hot path)
        # or "poll" (legacy fixed-interval loop, kept for parity checks)
        self.delivery = delivery
        # columnar=True: fetch delivers zero-copy BatchViews; False
        # materializes per-row Record lists (legacy allocation pattern,
        # kept for parity checks and the allocation-counter baseline)
        self.columnar = bool(columnar)
        # event queue backend: "calendar" (bucketed, the hot path) or
        # "heap" (legacy global heap) — pop order is bit-identical
        self.scheduler = scheduler
        # fetch_mode="fused" (default): one deliver event per
        # (subscriber, fetch cycle, landing time) cohort and one wakeup
        # event per _notify fan-out; "legacy" keeps one event per
        # partition / per waiter.  Every metric except the event-loop
        # counters is bit-identical between the two (see the ROADMAP
        # cohort-delivery contract and tests/test_fused_fetch.py).
        self.fetch_mode = fetch_mode
        self._comp_seq = 0

    # ------------------------------------------------------------------
    # Builder API
    # ------------------------------------------------------------------

    @classmethod
    def from_topology(cls, g: "nx.Graph", *, mode: str = "zk",
                      delivery: str = "wakeup", columnar: bool = True,
                      scheduler: str = "calendar",
                      fetch_mode: str = "fused") -> "PipelineSpec":
        """Build a spec from a generated topology graph.

        ``g`` follows the ``repro_torch.sweep.topologies`` contract: nodes carry
        ``kind`` ("host" or "switch", default host) and edges carry a
        ``cfg`` :class:`LinkCfg`.  Components and topics are added on top
        by the caller (or by ``repro_torch.sweep.scenarios.build_scenario``).
        """
        spec = cls(mode=mode, delivery=delivery, columnar=columnar,
                   scheduler=scheduler, fetch_mode=fetch_mode)
        for n, attrs in g.nodes(data=True):
            if attrs.get("kind", "host") == "switch":
                spec.add_switch(n)
            else:
                spec.add_host(
                    n, n_cores=int(attrs.get("n_cores", 8)),
                    cpu_percentage=float(attrs.get("cpu_percentage", 100.0)))
        for a, b, d in g.edges(data=True):
            cfg = d.get("cfg") or LinkCfg()
            spec.add_link(a, b, lat=cfg.lat_ms, bw=cfg.bw_mbps,
                          loss=cfg.loss_pct, st=cfg.src_port,
                          dt=cfg.dst_port)
        # geo_wan publishes its core-tier sites on the graph; carry them
        # so chaos plans can target the access tier for correlated faults
        spec.core_hosts = list(g.graph.get("core", []))
        return spec

    def add_host(self, name: str, *, n_cores: int = 8,
                 cpu_percentage: float = 100.0) -> "PipelineSpec":
        if name not in self.hosts:
            self.hosts[name] = HostSpec(name, n_cores=n_cores,
                                        cpu_percentage=cpu_percentage)
            self.network.add_host(name)
        return self

    def add_switch(self, name: str) -> "PipelineSpec":
        self.network.add_host(name)
        return self

    def add_link(self, a: str, b: str, *, lat: float = 0.1,
                 bw: float = 1_000.0, loss: float = 0.0,
                 st: int = 0, dt: int = 0) -> "PipelineSpec":
        self.network.add_link(a, b, LinkCfg(
            lat_ms=lat, bw_mbps=bw, loss_pct=loss, src_port=st, dst_port=dt))
        return self

    def _add_component(self, host: str, comp: Component) -> Component:
        self.add_host(host)
        self._comp_seq += 1
        comp.name = comp.name or f"{comp.role}{self._comp_seq}@{host}"
        self.hosts[host].components.append(comp)
        return comp

    def add_producer(self, host: str, type: str = "SYNTHETIC",
                     **cfg) -> Component:
        return self._add_component(host, Component(PRODUCER, type, cfg))

    def add_consumer(self, host: str, type: str = "STANDARD",
                     **cfg) -> Component:
        return self._add_component(host, Component(CONSUMER, type, cfg))

    def add_broker(self, host: str, **cfg) -> Component:
        return self._add_component(host, Component(BROKER, "KAFKA", cfg))

    def add_spe(self, host: str, type: str = "JAXSTREAM", **cfg) -> Component:
        return self._add_component(host, Component(SPE, type, cfg))

    def add_store(self, host: str, type: str = "KV", **cfg) -> Component:
        return self._add_component(host, Component(STORE, type, cfg))

    def add_topic(self, name: str, *, leader: Optional[str] = None,
                  replication: int = 1,
                  partitions: int = 1) -> "PipelineSpec":
        self.topics[name] = TopicCfg(name, leader, replication, partitions)
        return self

    def add_fault(self, at: float, kind: str, *target: str,
                  duration: float = 0.0, loss_pct: float = 0.0,
                  delay_s: float = 0.0) -> "PipelineSpec":
        self.faults.append(FaultCfg(at, kind, tuple(target), duration,
                                    loss_pct, delay_s))
        return self

    def set_chaos(self, **kw) -> "PipelineSpec":
        """Attach a seed-expanded adversarial plan (see :class:`ChaosCfg`)."""
        if "protect" in kw:
            kw["protect"] = tuple(kw["protect"])
        self.chaos = ChaosCfg(**kw)
        return self

    def set_telemetry(self, **kw) -> "PipelineSpec":
        """Enable observability (see :class:`~repro_torch.core.telemetry.TelemetryCfg`)."""
        self.telemetry = TelemetryCfg(**kw)
        return self

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def components(self, role: Optional[str] = None) -> list[Component]:
        out = []
        for h in self.hosts.values():
            out.extend(h.components if role is None else h.by_role(role))
        return out

    def host_of(self, comp: Component) -> str:
        for h in self.hosts.values():
            if comp in h.components:
                return h.name
        raise KeyError(comp.name)

    def broker_hosts(self) -> list[str]:
        return [h.name for h in self.hosts.values() if h.by_role(BROKER)]

    def validate(self) -> list[str]:
        """Static checks mirroring the paper's 'developer friendliness' goal."""
        problems = []
        brokers = self.broker_hosts()
        uses_topics = any(
            c.get("topic") or c.get("topicName") or c.get("in_topic")
            or c.get("out_topic") for c in self.components())
        if (self.topics or uses_topics) and not brokers:
            problems.append("topics configured but no broker component")
        for t in self.topics.values():
            if t.leader is not None and t.leader not in brokers:
                problems.append(
                    f"topic {t.name}: leader {t.leader} is not a broker host")
            if t.replication > max(1, len(brokers)):
                problems.append(
                    f"topic {t.name}: replication {t.replication} > "
                    f"{len(brokers)} brokers")
            if t.partitions < 1:
                problems.append(
                    f"topic {t.name}: partitions must be >= 1, "
                    f"got {t.partitions}")
        for c in self.components(SPE):
            tm = c.get("timeMode", "processing")
            if tm not in ("processing", "event"):
                problems.append(
                    f"spe {c.name}: timeMode must be 'processing' or "
                    f"'event', got {tm!r}")
            sem = c.get("semantics", "at_least_once")
            if sem not in ("at_least_once", "exactly_once"):
                problems.append(
                    f"spe {c.name}: semantics must be 'at_least_once' "
                    f"or 'exactly_once', got {sem!r}")
            for knob in ("window", "windowSlide", "allowedLateness",
                         "checkpointInterval"):
                v = float(c.get(knob, 0.0))
                if v < 0:
                    problems.append(
                        f"spe {c.name}: {knob} must be >= 0, got {v}")
            slide = float(c.get("windowSlide", 0.0))
            if slide > 0 and slide > float(c.get("window", 0.0)):
                problems.append(
                    f"spe {c.name}: windowSlide {slide} exceeds the "
                    f"window size {c.get('window')}")
            if sem == "exactly_once" \
                    and float(c.get("checkpointInterval", 0.0)) <= 0:
                problems.append(
                    f"spe {c.name}: exactly_once needs "
                    f"checkpointInterval > 0 (the commit cadence)")
            if sem == "exactly_once" and tm != "event":
                # the transactional output hold lives on the event-time
                # path only; silently emitting-then-replaying under a
                # config that promises exactly-once would be a lie
                problems.append(
                    f"spe {c.name}: exactly_once requires "
                    f"timeMode='event' (processing-time emissions are "
                    f"not held for the checkpoint commit)")
        # fail fast on typo'd fault targets: a nonexistent link or host
        # would otherwise surface mid-run as a KeyError deep in netem
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                problems.append(
                    f"fault {f}: unknown kind {f.kind!r} "
                    f"(one of {', '.join(FAULT_KINDS)})")
                continue
            unknown = [n for n in f.target if n not in self.network.g]
            if unknown:
                problems.append(
                    f"fault {f}: unknown node(s) {', '.join(unknown)}")
                continue
            if f.kind in ("link_down", "gray_loss"):
                if len(f.target) != 2:
                    problems.append(f"fault {f}: {f.kind} needs (a, b)")
                elif not self.network.g.has_edge(*f.target):
                    problems.append(
                        f"fault {f}: no link between "
                        f"{f.target[0]} and {f.target[1]}")
            else:                       # host_down | slow_host
                if len(f.target) != 1:
                    problems.append(f"fault {f}: {f.kind} needs one host")
            if f.kind == "gray_loss" and not 0.0 <= f.loss_pct <= 100.0:
                problems.append(
                    f"fault {f}: loss_pct must be in [0, 100]")
            if f.kind == "slow_host" and f.delay_s < 0:
                problems.append(f"fault {f}: delay_s must be >= 0")
        ch = self.chaos
        if ch is not None:
            if any(c < 0 for c in ch.counts()):
                problems.append("chaos: category counts must be >= 0")
            if any(ch.counts()) and ch.duration <= 0:
                problems.append(
                    "chaos: an active plan needs duration > 0")
            if ch.flap_links and not (0.0 < ch.flap_duty <= 1.0
                                      and ch.flap_period_s > 0):
                problems.append(
                    "chaos: flapping needs flap_duty in (0, 1] and "
                    "flap_period_s > 0")
            if not 0.0 <= ch.gray_max_loss_pct <= 100.0:
                problems.append(
                    "chaos: gray_max_loss_pct must be in [0, 100]")
            if ch.gray and (ch.gray_steps < 1 or ch.gray_step_s <= 0):
                problems.append(
                    "chaos: gray ramps need gray_steps >= 1 and "
                    "gray_step_s > 0")
            unknown = [h for h in ch.protect if h not in self.network.g]
            if unknown:
                problems.append(
                    f"chaos: protect names unknown host(s) "
                    f"{', '.join(unknown)}")
            if (ch.flap_links or ch.correlated or ch.gray) \
                    and not self.network.g.edges:
                problems.append("chaos: no links to degrade")
            if (ch.slow or ch.crashes) and not any(
                    h not in ch.protect for h in self.hosts):
                problems.append(
                    "chaos: slow/crash categories need at least one "
                    "unprotected component host")
        tel = self.telemetry
        if tel is not None:
            if tel.interval_s <= 0:
                problems.append("telemetry: interval_s must be > 0")
            if tel.ring_slots < 1:
                problems.append("telemetry: ring_slots must be >= 1")
            if tel.flight_slots < 1:
                problems.append("telemetry: flight_slots must be >= 1")
            if tel.lineage_k < 0:
                problems.append("telemetry: lineage_k must be >= 0")
        for name, h in self.hosts.items():
            if brokers and h.components and not any(
                    self.network.reachable(name, b) for b in brokers):
                problems.append(f"host {name} cannot reach any broker")
        return problems


# ---------------------------------------------------------------------------
# GraphML + YAML loading (paper Fig. 4)
# ---------------------------------------------------------------------------


def _load_cfg(value: str, base_dir: str) -> dict:
    """A node attribute either names a YAML file or holds inline YAML."""
    value = value.strip()
    path = os.path.join(base_dir, value)
    if os.path.exists(path):
        with open(path) as f:
            return yaml.safe_load(f) or {}
    parsed = yaml.safe_load(value)
    return parsed if isinstance(parsed, dict) else {"value": parsed}


def from_graphml(path: str, *, mode: Optional[str] = None,
                 delivery: Optional[str] = None,
                 fetch_mode: Optional[str] = None) -> PipelineSpec:
    """Parse a paper-style GraphML description (plus side YAML files).

    Table I parity: besides ``topicCfg``/``faultCfg``, graph-level
    attributes may select ``mode`` ("zk"/"kraft"), ``delivery``
    ("wakeup"/"poll"), ``fetchMode`` ("fused"/"legacy") and a default
    ``brokerCfg`` (YAML file or inline YAML) applied to every broker
    node — node-level ``brokerCfg`` entries override the graph-level
    defaults key-by-key.  Explicit keyword arguments take precedence
    over graph attributes.
    """
    g = nx.read_graphml(path)
    base = os.path.dirname(os.path.abspath(path))
    mode = mode or str(g.graph.get("mode", "zk"))
    delivery = delivery or str(g.graph.get("delivery", "wakeup"))
    fetch_mode = fetch_mode or str(g.graph.get("fetchMode", "fused"))
    spec = PipelineSpec(mode=mode, delivery=delivery,
                        fetch_mode=fetch_mode)
    base_broker_cfg = (_load_cfg(g.graph["brokerCfg"], base)
                       if "brokerCfg" in g.graph else {})

    # graph-level attributes
    if "topicCfg" in g.graph:
        for t in _load_cfg(g.graph["topicCfg"], base).get("topics", []):
            spec.add_topic(t["name"], leader=t.get("leader"),
                           replication=int(t.get("replication", 1)),
                           partitions=int(t.get("partitions", 1)))
    if "faultCfg" in g.graph:
        for f in _load_cfg(g.graph["faultCfg"], base).get("faults", []):
            spec.add_fault(
                float(f["at"]), f["kind"], *f.get("target", []),
                duration=float(f.get("duration", 0)),
                loss_pct=float(f.get("loss", 0)),
                delay_s=float(f.get("delay", 0)))
    if "chaosCfg" in g.graph:
        # graph-level chaos plan: YAML keys mirror ChaosCfg fields
        spec.set_chaos(**_load_cfg(g.graph["chaosCfg"], base))
    if "telemetryCfg" in g.graph:
        # graph-level observability: YAML keys mirror TelemetryCfg fields
        spec.set_telemetry(**_load_cfg(g.graph["telemetryCfg"], base))

    for node, attrs in g.nodes(data=True):
        has_comp = any(k in attrs for k in (
            "prodType", "consType", "streamProcType", "storeType",
            "brokerCfg"))
        if not has_comp:               # switch (paper: <node id="s1"/>)
            spec.add_switch(node)
            continue
        spec.add_host(node, cpu_percentage=float(
            attrs.get("cpuPercentage", 100.0)))
        if "prodType" in attrs:
            cfg = _load_cfg(attrs.get("prodCfg", "{}"), base)
            spec.add_producer(node, attrs["prodType"], **cfg)
        if "consType" in attrs:
            cfg = _load_cfg(attrs.get("consCfg", "{}"), base)
            spec.add_consumer(node, attrs["consType"], **cfg)
        if "streamProcType" in attrs:
            cfg = _load_cfg(attrs.get("streamProcCfg", "{}"), base)
            spec.add_spe(node, attrs["streamProcType"], **cfg)
        if "storeType" in attrs:
            cfg = _load_cfg(attrs.get("storeCfg", "{}"), base)
            spec.add_store(node, attrs["storeType"], **cfg)
        if "brokerCfg" in attrs:
            cfg = {**base_broker_cfg, **_load_cfg(attrs["brokerCfg"], base)}
            spec.add_broker(node, **cfg)

    for a, b, attrs in g.edges(data=True):
        spec.add_link(
            a, b,
            lat=float(attrs.get("lat", 0.1)),
            bw=float(attrs.get("bw", 1_000.0)),
            loss=float(attrs.get("loss", 0.0)),
            st=int(attrs.get("st", 0)),
            dt=int(attrs.get("dt", 0)),
        )
    return spec
