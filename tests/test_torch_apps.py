"""The paper's stream applications in the port against the reference.

Each pipeline (the Table II applications of ``tests/test_engine_apps.py``
and an Ocampo traffic-monitoring pipeline after
``benchmarks/fig7_reproductions.py``) is built through each package's own
``PipelineSpec`` and run under the same seed; the port's SPE runs its
tensor compute with ``device="cpu"``.  The contract (ROADMAP C3): every
``Engine.metrics()`` field outside the wall times is equal, counts and
argmax results are exact, float payload fields agree at rtol 1e-6
(1e-5 for the SVM scores, which go through 200 training steps), and for
the measured-wall query every ``spe_exec`` event field but ``wall`` is
equal.  The absolute tolerance equals the relative one: the summed terms
are of order 1 (lexicon scores, SVM score terms), so a float that
cancels to about 0 differs by float32 rounding of order-1 terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import spe as jspe
from repro.core import store as jstore
from repro.core.spec import Component as JComponent
from repro_torch.core import spe as tspe
from repro_torch.core import store as tstore
from repro_torch.core.spec import Component

WALL_KEYS = ("wall_s", "profile_wall")
RTOL = {"sentiment": 1e-6, "ride_select": 1e-6, "fraud_svm": 1e-5,
        "traffic_metrics": 1e-6}


# ---------------------------------------------------------------------------
# pipelines (both packages; the port's SPE on the CPU)
# ---------------------------------------------------------------------------


def pipeline(core, *, topics, spes, producers=()):
    spec = core.PipelineSpec(mode="zk")
    spec.add_switch("s1")
    spec.add_host("b").add_link("b", "s1", lat=1.0, bw=1000.0)
    spec.add_broker("b")
    for t in topics:
        spec.add_topic(t, leader="b")
    for i, (typ, kw) in enumerate(producers):
        spec.add_host(f"p{i}").add_link(f"p{i}", "s1", lat=1.0, bw=1000.0)
        spec.add_producer(f"p{i}", typ, **kw)
    for i, (query, kw) in enumerate(spes):
        spec.add_host(f"w{i}").add_link(f"w{i}", "s1", lat=1.0, bw=1000.0)
        spec.add_spe(f"w{i}", query=query, device="cpu", **kw)
    spec.add_host("c").add_link("c", "s1", lat=1.0, bw=1000.0)
    sink = spec.add_consumer("c", "METRICS", topic=topics[-1],
                             pollInterval=0.05)
    return spec, sink


def sentiment(core):
    spec, sink = pipeline(
        core, topics=["tweets", "scores"],
        producers=[("DIRECTORY", dict(
            topic="tweets", totalMessages=3, interval=0.2,
            docs=["good great love", "terrible awful bad",
                  "okay boring but happy"]))],
        spes=[("sentiment", dict(inTopic="tweets", outTopic="scores"))])
    return spec, sink, None, 10.0


def _inject(rows, topic):
    def inject(eng):
        eng.schedule(0.1, lambda: [
            eng.cluster.produce("b", "t", topic, r, 64) for r in rows])
    return inject


def ride_select(core):
    rng = np.random.default_rng(4)
    rides = [{"area": str(a), "tip": float(t)} for a, t in zip(
        rng.choice(list("ABCDEFG"), 40), rng.gamma(2.0, 3.0, 40))]
    spec, sink = pipeline(
        core, topics=["rides", "best"],
        spes=[("ride_select", dict(inTopic="rides", outTopic="best",
                                   window=1.0))])
    return spec, sink, _inject(rides, "rides"), 8.0


def fraud_svm(core):
    rng = np.random.default_rng(1)
    rows = ([{"x": rng.normal(0, 1, 8).tolist()} for _ in range(10)]
            + [{"x": rng.normal(2.5, 1, 8).tolist()} for _ in range(5)])
    spec, sink = pipeline(
        core, topics=["txn", "fraud"],
        spes=[("fraud_svm", dict(inTopic="txn", outTopic="fraud",
                                 window=1.0, dim=8))])
    return spec, sink, _inject(rows, "txn"), 10.0


def traffic_metrics(core, n_users=6, horizon=6.0):
    """The Ocampo scenario of ``fig7_reproductions.ocampo``, with few
    users and a short horizon, and a sink on its output topic."""
    spec, sink = pipeline(
        core, topics=["pkts", "stats"],
        spes=[("traffic_metrics", dict(inTopic="pkts", outTopic="stats",
                                       window=1.0, pollInterval=0.2))])
    for i in range(n_users):
        h = f"u{i}"
        spec.add_host(h).add_link(h, "s1", lat=0.5, bw=100.0)
        spec.add_producer(h, "PACKET", topic="pkts", ratePps=20.0,
                          pktBytes=256)
    return spec, sink, None, horizon


APPS = {"sentiment": sentiment, "ride_select": ride_select,
        "fraud_svm": fraud_svm, "traffic_metrics": traffic_metrics}


def run(core, store, build, seed=0):
    store.reset_registry()
    spec, sink, inject, horizon = build(core)
    eng = core.Engine(spec, seed=seed)
    if inject is not None:
        inject(eng)
    eng.run(until=horizon)
    rt = [rt for rt in eng.runtimes if rt.name == sink.name][0]
    return eng, [p.get("data", p) for p in rt.payloads]


def assert_c3(port, ref, rtol, path="payload"):
    """Same structure; ints, strings and bools exact; floats allclose
    (atol = rtol, see the module docstring)."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), path
        for k in ref:
            assert_c3(port[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_c3(a, b, rtol, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(port, float), path
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol,
                                   err_msg=path)
    else:
        assert type(port) is type(ref) and port == ref, path


def deterministic(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in WALL_KEYS}


# ---------------------------------------------------------------------------
# the applications through the gym, port against reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(APPS))
def test_app_matches_reference(name):
    jeng, jpay = run(jcore, jstore, APPS[name])
    teng, tpay = run(tcore, tstore, APPS[name])
    assert jpay, "the reference emitted nothing"
    assert_c3(tpay, jpay, RTOL[name])
    assert deterministic(teng.metrics()) == deterministic(jeng.metrics())
    assert teng.n_events == jeng.n_events
    jex = jeng.monitor.events_of("spe_exec")
    tex = teng.monitor.events_of("spe_exec")
    assert bool(tex) == (name == "traffic_metrics")   # measure_wall only
    assert [{k: v for k, v in e.items() if k != "wall"} for e in tex] == \
        [{k: v for k, v in e.items() if k != "wall"} for e in jex]


def test_app_outputs_are_the_papers():
    """The port on its own gives what ``tests/test_engine_apps.py`` asks
    of the reference."""
    _, scores = run(tcore, tstore, sentiment)
    assert scores[0]["polarity"] > 0 > scores[1]["polarity"]
    _, fraud = run(tcore, tstore, fraud_svm)
    assert fraud[0]["n"] == 15 and 3 <= fraud[0]["anomalies"] <= 7
    _, rides = run(tcore, tstore, ride_select)
    means = rides[0]["areas"]
    assert rides[0]["best_area"] == max(means, key=means.get)
    assert rides[0]["mean_tip"] == means[rides[0]["best_area"]]


# ---------------------------------------------------------------------------
# the queries called directly on the same records
# ---------------------------------------------------------------------------


class _R:
    def __init__(self, payload):
        self.payload = payload
        self.size = 64


def both_queries(name, **cfg):
    jq = jspe.QUERIES[name](JComponent("spe", "JAXSTREAM", dict(cfg),
                                       name="spe_t"))
    tq = tspe.QUERIES[name](Component("spe", "JAXSTREAM",
                                      dict(cfg, device="cpu"),
                                      name="spe_t"))
    return jq, tq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ride_select_query_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    rows = [_R({"area": f"a{int(a)}", "tip": float(t)})
            for a, t in zip(rng.integers(0, 23, n), rng.gamma(2.0, 4.0, n))]
    jq, tq = both_queries("ride_select")
    [(want, _)] = jq(None, None, rows)
    [(got, _)] = tq(None, None, rows)
    assert_c3(got, want, 1e-6)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 200])
def test_traffic_query_matches_reference_and_numpy(n):
    rng = np.random.default_rng(n)
    services = ["ftp", "web", "dns", "mail", "other"]
    pkts = [{"service": str(s), "bytes": int(b)} for s, b in zip(
        rng.choice(services, n), rng.integers(40, 1500, n))]
    jq, tq = both_queries("traffic_metrics")
    [(want, _)] = jq(None, None, [_R(p) for p in pkts])
    [(got, _)] = tq(None, None, [_R(p) for p in pkts])
    assert_c3(got, want, 1e-6)
    # unknown services count as the first one, as in the reference
    sid = {s: i for i, s in enumerate(["ftp", "web", "dns", "mail"])}
    conns = np.zeros(4)
    np.add.at(conns, [sid.get(p["service"], 0) for p in pkts], 1.0)
    assert [got["connections"][s] for s in sid] == conns.tolist()


@pytest.mark.parametrize("seed", [0, 3])
def test_sentiment_fn_matches_reference(seed):
    rng = np.random.default_rng(seed)
    words = list(tspe._LEXICON) + ["the", "a", "movie"]
    for _ in range(20):
        text = " ".join(rng.choice(words, int(rng.integers(0, 12))))
        want, _ = jspe._sentiment_fn({"text": text})
        got, _ = tspe._sentiment_fn({"text": text}, device="cpu")
        assert_c3(got, want, 1e-6)


# ---------------------------------------------------------------------------
# the fraud SVM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [4, 8, 16])
def test_fraud_svm_weights_match_reference(dim):
    jq, tq = both_queries("fraud_svm", dim=dim)
    np.testing.assert_allclose(tq.w.numpy(), np.asarray(jq.w), rtol=1e-5,
                               atol=1e-6)


def test_svm_grad_matches_jax_grad_at_zero_margins():
    """The hinge's subgradient at a zero margin is jnp.maximum's: 1/2."""
    rng = np.random.default_rng(7)
    dim, n = 6, 64
    X = rng.normal(0, 1, (n, dim)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = np.zeros(dim, np.float32)
    w[-1] = 1.0
    X[: n // 2, :-1] = 0.0            # margin 1 - y * 1: exactly 0 for y = 1
    assert (1.0 - y * (X[:, :-1] @ w[:-1] + w[-1]) == 0).sum() > 4

    def loss(w, X, y):
        margins = 1.0 - y * (X[:, :-1] @ w[:-1] + w[-1])
        return jnp.mean(jnp.maximum(margins, 0.0)) + 1e-3 * w @ w

    want = np.asarray(jax.grad(loss)(jnp.asarray(w), jnp.asarray(X),
                                     jnp.asarray(y)))
    got = tspe._svm_grad(torch.from_numpy(w), torch.from_numpy(X),
                         torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fraud_svm_scores_invariant_to_padding():
    """The port's copy of ``tests/test_engine_batch.py``'s test."""
    _, q = both_queries("fraud_svm", dim=8)
    rng = np.random.default_rng(5)
    xs = [rng.normal(0, 1, 8).tolist() for _ in range(21)]
    # full batch (pads 21 -> 32) vs one-at-a-time (pads 1 -> 16)
    [(full, _)] = q(None, None, [_R({"x": x}) for x in xs])
    singles = [q(None, None, [_R({"x": x})])[0][0]["scores"][0] for x in xs]
    assert np.allclose(full["scores"], singles, atol=1e-5)
    assert full["n"] == 21


# ---------------------------------------------------------------------------
# device: cuda unless the spec says cpu, never a fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(APPS))
def test_app_queries_default_to_cuda(name):
    comp = Component("spe", "JAXSTREAM", {}, name="spe_t")
    if torch.cuda.is_available():
        assert tspe.QUERIES[name](comp).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tspe.QUERIES[name](comp)
