"""Default scenario builder: a flat params dict -> concrete PipelineSpec.

This is the bridge between a declarative :class:`~repro_torch.sweep.grid.
SweepSpec` grid point and a runnable pipeline: a generated topology
(``repro_torch.sweep.topologies``), brokers/topics/producers/consumers placed
over its hosts, uniform link-loss and named fault-pattern knobs, plus
broker/delivery tuning (Table I parity with the GraphML surface).

Recognized params (all optional unless noted):

topology      generator name (default "star"); ``topo`` = extra kwargs;
              ``topo_seed`` defaults to ``seed``
n_hosts       REQUIRED — emulated host count (switches come on top)
n_brokers     brokers on the first hosts (default 3, capped to n_hosts-1)
replication / n_topics / n_producers / n_consumers
partitions    partitions per topic (default 1; per-partition leaders
              rotate over the broker list)
consumer_groups
              g > 0 assigns consumer i the group "g{i % g}": members of
              one group split each subscribed topic's partitions via the
              range assignor and share committed offsets
rate_kbps / msg_size        SYNTHETIC producer knobs
linger_ms / batch_bytes     producer batch accumulator (Kafka linger.ms
                            / batch.size; 0 = legacy per-record produce)
n_keys        > 0 routes producer records over a cycling key space
              (keyed partitioning); 0 = unkeyed round-robin
poll_interval               subscriber cadence (also the wakeup fallback)
delivery / mode             "wakeup"|"poll", "zk"|"kraft"
columnar      zero-copy BatchView delivery (default True); False
              materializes per-row Records at fetch — the allocation
              baseline axis (behavior is bit-identical either way)
scheduler     engine event queue: "calendar" (default) | "heap"
              (legacy global heap; pop order bit-identical)
broker_cfg    dict merged into every broker component (Table I brokerCfg)
loss_pct      uniform extra loss applied to every link
reach_cache   per-epoch reachability memoization toggle (default on;
              the scale benchmark's before/after axis)
route_mode    "table" (default — per-epoch vectorized routing tables)
              | "ondemand" (legacy per-source SSSP; the parity baseline
              — results are bit-identical, asserted in CI).
              reach_cache=0 always implies on-demand recomputation.
fetch_mode    "fused" (default — one fused fetch cycle per poll, same-tick
              deliveries coalesced into cohort events) | "legacy"
              (per-partition deliver events; the parity baseline — all
              metrics except event-loop counters bit-identical, CI-gated)
windowed / window_s
              truthy ``windowed`` (or ``window_s > 0``) places one
              stream processor on the last host: topics[0] -> "agg",
              keyed by producer (``keyField="src"``), with the
              operator-graph knobs below (event-time by default)
time_mode / allowed_lateness / window_slide_s / spe_agg
              SPE operator knobs (core/spe.py): "event"|"processing",
              lateness bound (s), sliding-window slide (s, 0=tumbling),
              aggregate name (count|sum|mean)
checkpoint_interval / spe_semantics
              checkpointed recovery: snapshot cadence (s, 0=off) and
              "at_least_once"|"exactly_once" emission semantics
et_jitter_s   producers backdate event_time by uniform(0, jitter) —
              the out-of-order model feeding late-record handling
fault         none | partition | broker_down | gray_loss | spe_down,
              shaped by fault_at / fault_duration / fault_loss_pct
              (spe_down kills the stream processor's host — the
              recovery axis; requires a windowed SPE)
consumer_cost extra per-record processing cost (s) on every consumer —
              the overload knob for backpressure/shedding scenarios
queue_bytes   > 0 bounds every subscriber's ingest queue at that many
              bytes (consumers and the windowed SPE); 0 = unbounded
shed_policy   what a full bounded queue does: "pause" (default —
              backpressure: fetches stop until the queue drains) |
              "drop_oldest" | "drop_newest" | "sample" (deterministic
              byte-proportional thinning; no RNG)
chaos         intensity c > 0 expands a seeded chaos plan over the
              middle 80% of the run: c flapping links, c gray-loss
              ramps, c slow hosts and c crash/heal cycles, drawn from
              client_rng("chaos") (brokers are protected so the small
              CI grids keep a live cluster)
telemetry     sampling interval (s) > 0 enables the observability layer
              (core/telemetry.py): time-series rings, per-stage latency
              histograms, flight recorder — all deterministic, all in
              the fingerprint.  0 (default) = off, zero added events.
profile       truthy (with telemetry on) enables the engine profiler:
              profile_counts is fingerprinted, profile_wall is a
              TIMING_KEY
lineage_k     full per-stage traces for the first K records per topic
seed / horizon              consumed by the sweep runner, not here
"""
from __future__ import annotations

from repro_torch.core.spec import SPE, PipelineSpec
from repro_torch.sweep import topologies


def build_scenario(p: dict) -> PipelineSpec:
    """Build the pipeline for one grid point (must stay deterministic)."""
    n_hosts = int(p["n_hosts"])
    g = topologies.generate(
        p.get("topology", "star"), n_hosts,
        seed=int(p.get("topo_seed", p.get("seed", 0))),
        **dict(p.get("topo", {})))
    spec = PipelineSpec.from_topology(
        g, mode=p.get("mode", "zk"), delivery=p.get("delivery", "wakeup"),
        columnar=bool(p.get("columnar", True)),
        scheduler=p.get("scheduler", "calendar"),
        fetch_mode=str(p.get("fetch_mode", "fused")))
    spec.network.reach_cache = bool(p.get("reach_cache", True))
    spec.network.route_mode = str(p.get("route_mode", "table"))
    if p.get("loss_pct"):
        for a, b in spec.network.g.edges:
            spec.network.link(a, b).loss_pct = float(p["loss_pct"])

    hosts = topologies.hosts_of(g)
    n_brokers = max(1, min(int(p.get("n_brokers", 3)), n_hosts - 1))
    brokers = hosts[:n_brokers]
    for b in brokers:
        spec.add_broker(b, **dict(p.get("broker_cfg", {})))
    n_topics = max(1, int(p.get("n_topics", n_brokers)))
    replication = max(1, min(int(p.get("replication", 1)), n_brokers))
    partitions = max(1, int(p.get("partitions", 1)))
    topics = [f"t{i}" for i in range(n_topics)]
    for i, t in enumerate(topics):
        spec.add_topic(t, leader=brokers[i % n_brokers],
                       replication=replication, partitions=partitions)

    rest = hosts[n_brokers:]
    n_prod = max(1, min(int(p.get("n_producers", n_topics)), len(rest)))
    for i, h in enumerate(rest[:n_prod]):
        spec.add_producer(h, "SYNTHETIC", topics=[topics[i % n_topics]],
                          rateKbps=float(p.get("rate_kbps", 8.0)),
                          msgSize=int(p.get("msg_size", 512)),
                          lingerMs=float(p.get("linger_ms", 0.0)),
                          batchBytes=int(p.get("batch_bytes", 1 << 14)),
                          nKeys=int(p.get("n_keys", 0)),
                          etJitterS=float(p.get("et_jitter_s", 0.0)))
    consumers = rest[n_prod:]
    if "n_consumers" in p:
        consumers = consumers[:int(p["n_consumers"])]
    n_groups = int(p.get("consumer_groups", 0))
    queue_bytes = int(p.get("queue_bytes", 0))
    shed_policy = p.get("shed_policy", "pause")
    for i, h in enumerate(consumers):
        subs = {topics[i % n_topics], topics[(i + 1) % n_topics]}
        cfg = dict(topics=sorted(subs),
                   pollInterval=float(p.get("poll_interval", 0.1)))
        if n_groups > 0:
            cfg["group"] = f"g{i % n_groups}"
        if p.get("consumer_cost"):
            cfg["perRecordCost"] = float(p["consumer_cost"])
        if queue_bytes > 0:
            cfg["queueBytes"] = queue_bytes
            cfg["shedPolicy"] = shed_policy
        spec.add_consumer(h, "STANDARD", **cfg)
    windowed = p.get("windowed")
    if windowed is None:                 # explicit 0 wins over window_s
        windowed = float(p.get("window_s", 0.0)) > 0
    if windowed:
        # one operator-graph stream processor on the last host:
        # topics[0] -> "agg", keyed by producing component
        spec.add_topic("agg", leader=brokers[0])
        spec.add_spe(
            hosts[-1], query="identity", inTopic=topics[0],
            outTopic="agg",
            timeMode=p.get("time_mode", "event"),
            window=float(p.get("window_s", 1.0)),
            windowSlide=float(p.get("window_slide_s", 0.0)),
            allowedLateness=float(p.get("allowed_lateness", 0.0)),
            checkpointInterval=float(p.get("checkpoint_interval", 0.0)),
            semantics=p.get("spe_semantics", "at_least_once"),
            keyField="src", agg=p.get("spe_agg", "count"),
            pollInterval=float(p.get("poll_interval", 0.1)),
            **({"queueBytes": queue_bytes, "shedPolicy": shed_policy}
               if queue_bytes > 0 else {}))
    _install_fault(spec, p, brokers)
    chaos = int(p.get("chaos", 0))
    if chaos > 0:
        horizon = float(p.get("horizon", 30.0))
        spec.set_chaos(start=0.1 * horizon, duration=0.8 * horizon,
                       flap_links=chaos, gray=chaos, slow=chaos,
                       crashes=chaos, protect=tuple(brokers))
    tel = float(p.get("telemetry", 0.0))
    if tel > 0:
        spec.set_telemetry(interval_s=tel,
                           profile=bool(p.get("profile", 0)),
                           lineage_k=int(p.get("lineage_k", 0)))
    return spec


def _install_fault(spec: PipelineSpec, p: dict, brokers: list[str]) -> None:
    fault = p.get("fault")
    if not fault or fault == "none":
        return
    horizon = float(p.get("horizon", 30.0))
    at = float(p.get("fault_at", horizon * 0.25))
    dur = float(p.get("fault_duration", horizon * 0.25))
    b0 = brokers[0]
    nbr = sorted(spec.network.g.neighbors(b0))[0]
    if fault == "partition":
        spec.add_fault(at, "link_down", b0, nbr, duration=dur)
    elif fault == "broker_down":
        spec.add_fault(at, "host_down", brokers[-1], duration=dur)
    elif fault == "gray_loss":
        spec.add_fault(at, "gray_loss", b0, nbr, duration=dur,
                       loss_pct=float(p.get("fault_loss_pct", 30.0)))
    elif fault == "spe_down":
        spe_hosts = [h.name for h in spec.hosts.values() if h.by_role(SPE)]
        if not spe_hosts:
            raise ValueError("fault 'spe_down' needs a windowed SPE "
                             "(set windowed=1 or window_s > 0)")
        spec.add_fault(at, "host_down", spe_hosts[0], duration=dur)
    else:
        raise ValueError(f"unknown fault pattern {fault!r}")
