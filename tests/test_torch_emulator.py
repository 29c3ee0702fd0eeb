"""The port's emulator copy (``repro_torch.core``) against the reference.

The same spec, built through each package's own ``PipelineSpec``, runs
under the same seed in both ``Engine``s.  Every ``Engine.metrics()``
field outside the wall times must be equal.  The one float reduction
that changed backend — ``WindowAggregate``'s masked sum, jnp in the
reference and torch here — is compared allclose in float32 (ROADMAP C3);
counts and window bounds stay exact.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.kernels import cohort as jcohort, netcalc as jnetcalc
from repro_torch.kernels import cohort as tcohort, netcalc as tnetcalc

WALL_KEYS = ("wall_s", "profile_wall")


def quickstart(core):
    spec = core.PipelineSpec()
    spec.add_switch("s1")
    for host in ["source", "broker", "splitter", "counter", "sink"]:
        spec.add_host(host)
        spec.add_link(host, "s1", lat=2.0, bw=1000.0)
    spec.add_broker("broker")
    for topic in ["raw-data", "words", "counts"]:
        spec.add_topic(topic, leader="broker")
    spec.add_producer("source", "DIRECTORY", topic="raw-data",
                      docs=["the quick brown fox", "the lazy dog",
                            "the fox jumps over the dog"],
                      totalMessages=3, interval=0.5)
    spec.add_spe("splitter", query="split", inTopic="raw-data",
                 outTopic="words")
    spec.add_spe("counter", query="count", inTopic="words",
                 outTopic="counts")
    spec.add_consumer("sink", "METRICS", topic="counts", pollInterval=0.05)
    return spec, 15.0


def partitioned_chaos(core):
    spec = core.PipelineSpec(delivery="wakeup")
    spec.add_switch("s1")
    for h in ("b", "p1", "w", "c"):
        spec.add_host(h).add_link(h, "s1", lat=1.0, bw=1000.0)
    spec.add_broker("b")
    spec.add_topic("in", leader="b", partitions=2)
    spec.add_topic("agg", leader="b")
    spec.add_producer("p1", "SYNTHETIC", topics=["in"], rateKbps=40.0,
                      msgSize=500, totalMessages=60, etJitterS=0.3)
    spec.add_spe("w", query="identity", inTopic="in", outTopic="agg",
                 timeMode="event", window=1.0, allowedLateness=0.2,
                 keyField="src", agg="count", checkpointInterval=0.5,
                 semantics="exactly_once", pollInterval=0.1,
                 queueBytes=2048, shedPolicy="pause")
    spec.add_consumer("c", "METRICS", topic="agg", pollInterval=0.1)
    spec.set_chaos(start=3.0, duration=10.0, crashes=2,
                   crash_downtime_s=2.0, protect=("b", "p1", "c"))
    return spec, 40.0


def event_windows(agg):
    def build(core):
        spec = core.PipelineSpec(delivery="poll")
        spec.add_switch("s1")
        for h in ["b", "p1", "w", "c"]:
            spec.add_host(h).add_link(h, "s1", lat=1.0, bw=1000.0)
        spec.add_broker("b")
        spec.add_topic("in", leader="b", partitions=2)
        spec.add_topic("agg", leader="b")
        spec.add_producer("p1", "SYNTHETIC", topics=["in"], rateKbps=40.0,
                          msgSize=500, totalMessages=60, etJitterS=0.3)
        spec.add_spe("w", query="identity", inTopic="in", outTopic="agg",
                     timeMode="event", window=1.0, allowedLateness=0.2,
                     keyField="src", agg=agg, valueField="seq",
                     pollInterval=0.1)
        spec.add_consumer("c", "METRICS", topic="agg", pollInterval=0.1)
        return spec, 30.0
    return build


def run(core, build, seed):
    spec, horizon = build(core)
    eng = core.Engine(spec, seed=seed)
    eng.run(until=horizon)
    return eng


def sink_payloads(eng):
    out = []
    for rt in eng.runtimes:
        if hasattr(rt, "payloads"):
            out.extend(rt.payloads)
    return out


def deterministic(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in WALL_KEYS}


@pytest.mark.parametrize("build,seed", [
    (quickstart, 0),
    (partitioned_chaos, 3),
    (event_windows("count"), 3),
])
def test_metrics_equal_reference(build, seed):
    ref = run(jcore, build, seed)
    port = run(tcore, build, seed)
    assert deterministic(port.metrics()) == deterministic(ref.metrics())
    assert port.n_events == ref.n_events
    payloads = sink_payloads(port)
    assert payloads and payloads == sink_payloads(ref)


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_float_window_aggregates_allclose(agg):
    """Float window values agree to float32 rounding (ROADMAP C3); every
    other field of every emitted window, and every metric, is exact."""
    build = event_windows(agg)
    ref = run(jcore, build, 3)
    port = run(tcore, build, 3)
    assert deterministic(port.metrics()) == deterministic(ref.metrics())
    rp, pp = sink_payloads(ref), sink_payloads(port)
    assert len(pp) == len(rp) > 0
    for a, b in zip(pp, rp):
        a, b = a.get("data", a), b.get("data", b)
        assert {k: v for k, v in a.items() if k != "value"} == \
            {k: v for k, v in b.items() if k != "value"}
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-6)


def test_every_reference_query_is_ported():
    """Every query name of the reference resolves in the port, to the
    class of the same name; an unknown name still raises KeyError."""
    from repro.core.spe import QUERIES
    from repro_torch.core.spe import query_class
    for name, cls in QUERIES.items():
        assert query_class(name).__name__ == cls.__name__
    with pytest.raises(KeyError):
        query_class("no_such_query")


def test_cohort_and_netcalc_match_reference():
    rng = np.random.default_rng(0)
    ets = rng.uniform(0, 100, 257)
    np.testing.assert_array_equal(tcohort.pane_starts(ets, 0.7),
                                  jcohort.pane_starts(ets, 0.7))
    assert tcohort.group_spans(np.sort(np.round(ets))) == \
        jcohort.group_spans(np.sort(np.round(ets)))
    lat, bw = rng.uniform(0, 1, 64), rng.uniform(1, 1e9, 64)
    bw[::7] = np.inf
    extra = rng.uniform(0, 1e-3, 64)
    np.testing.assert_array_equal(tnetcalc.delay_many(lat, bw, 1500, extra),
                                  jnetcalc.delay_many(lat, bw, 1500, extra))
