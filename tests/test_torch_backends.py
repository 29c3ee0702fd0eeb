"""The torch backends of the emulator's float64 arithmetic (ROADMAP A8b).

``REPRO_COHORT_BACKEND`` and ``REPRO_NETCALC_BACKEND`` select the
backend of ``kernels.cohort.pane_starts`` and ``kernels.netcalc.
delay_many``: numpy by default, ``torch`` on the GPU, ``torch:cpu`` on
the CPU.  The ops are IEEE float64 ``floor``, ``/``, ``*`` and ``+``,
each correctly rounded, so every backend must give numpy's bits:
checked here on the CPU against the port's numpy path and the
reference's jax backend (with x64, in a subprocess, so that this
process keeps JAX's default), with ``inf`` bandwidths, ``extra_s`` unset
and set, and an empty cohort; then an emulator spec with fused fetch
and a tumbling window gives the same ``Engine.metrics()`` under both
backends; and ``torch`` without a GPU raises.  The GPU itself is
checked by ``chip_smoke.py`` (phase m).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.kernels import cohort, netcalc

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SIZES = (0.7, 1.0, 1e-3, 3.0e5)
NBYTES = (0, 1500, 2**40 + 3)


def _inputs(n: int, seed: int = 0) -> dict:
    """Event times over many scales (negative, sub-ms, ~1e9 s), latencies,
    bandwidths with every 7th infinite, and slow-host extras."""
    rng = np.random.default_rng(seed)
    ets = np.concatenate([rng.uniform(-50, 100, n // 2),
                          rng.uniform(0, 1e9, n - n // 2)])
    bw = rng.uniform(1, 1e11, n)
    bw[::7] = np.inf
    return {"ets": ets, "lat": rng.uniform(0, 1, n), "bw": bw,
            "extra": rng.uniform(0, 1e-3, n)}


CASES = {"seeded": _inputs(4099), "empty": _inputs(0)}


def _numpy(x: dict) -> dict:
    out = {}
    for size in SIZES:
        out[f"pane/{size}"] = cohort._pane_starts_np(x["ets"], size)
    for nb in NBYTES:
        out[f"delay/{nb}"] = netcalc._delay_many_np(x["lat"], x["bw"], nb,
                                                    None)
        out[f"delay/{nb}/extra"] = netcalc._delay_many_np(
            x["lat"], x["bw"], nb, x["extra"])
    return out


def _torch_cpu(x: dict) -> dict:
    out = {}
    for size in SIZES:
        out[f"pane/{size}"] = cohort._pane_starts_torch(x["ets"], size,
                                                        "torch:cpu")
    for nb in NBYTES:
        out[f"delay/{nb}"] = netcalc._delay_many_torch(
            x["lat"], x["bw"], nb, None, "torch:cpu")
        out[f"delay/{nb}/extra"] = netcalc._delay_many_torch(
            x["lat"], x["bw"], nb, x["extra"], "torch:cpu")
    return out


JAX_SIDE = """
import sys
import jax
import numpy as np
jax.config.update("jax_enable_x64", True)
from repro.kernels import cohort, netcalc
x = dict(np.load(sys.argv[1]))
out = {}
for size in %r:
    out[f"pane/{size}"] = cohort._pane_starts_jax(x["ets"], size)
for nb in %r:
    out[f"delay/{nb}"] = netcalc._delay_many_jax(x["lat"], x["bw"], nb, None)
    out[f"delay/{nb}/extra"] = netcalc._delay_many_jax(
        x["lat"], x["bw"], nb, x["extra"])
np.savez(sys.argv[2], **out)
""" % (SIZES, NBYTES)


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """The reference's jax backend with x64 on each case's inputs."""
    tmp = tmp_path_factory.mktemp("x64")
    out = {}
    for name, x in CASES.items():
        np.savez(tmp / f"{name}_in.npz", **x)
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", JAX_SIDE,
                        str(tmp / f"{name}_in.npz"),
                        str(tmp / f"{name}_out.npz")],
                       env=env, check=True, timeout=120)
        out[name] = dict(np.load(tmp / f"{name}_out.npz"))
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float64, a.dtype
    return a.view(np.uint64)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_cpu_backend_is_numpy_bit_for_bit(case):
    want, got = _numpy(CASES[case]), _torch_cpu(CASES[case])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                      err_msg=key)
    if case == "seeded":
        # the serialization guard: x / inf == 0.0, so lat is kept exactly
        lat = CASES[case]["lat"]
        assert (got["delay/1500"][::7] == lat[::7]).all()


@pytest.mark.parametrize("case", list(CASES))
def test_torch_cpu_backend_is_the_jax_backend_with_x64(case, jax_x64):
    got = _torch_cpu(CASES[case])
    assert sorted(got) == sorted(jax_x64[case])
    for key, want in jax_x64[case].items():
        np.testing.assert_array_equal(_bits(got[key]), _bits(want),
                                      err_msg=key)


def test_variables_select_the_backend(monkeypatch):
    """The public functions go to the torch backend only under the
    variables, with the device their value names."""
    x = CASES["seeded"]
    calls = []
    for mod, name in ((cohort, "_pane_starts_torch"),
                      (netcalc, "_delay_many_torch")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.append((name, a[-1])), fn(*a))[1])
    cohort.pane_starts(x["ets"], 0.7)
    netcalc.delay_many(x["lat"], x["bw"], 1500, x["extra"])
    assert calls == []
    monkeypatch.setenv("REPRO_COHORT_BACKEND", "torch:cpu")
    monkeypatch.setenv("REPRO_NETCALC_BACKEND", "torch:cpu")
    a = cohort.pane_starts(x["ets"], 0.7)
    b = netcalc.delay_many(x["lat"], x["bw"], 1500, x["extra"])
    assert calls == [("_pane_starts_torch", "torch:cpu"),
                     ("_delay_many_torch", "torch:cpu")]
    np.testing.assert_array_equal(_bits(a), _bits(
        cohort._pane_starts_np(x["ets"], 0.7)))
    np.testing.assert_array_equal(_bits(b), _bits(
        netcalc._delay_many_np(x["lat"], x["bw"], 1500, x["extra"])))


def _window_spec(core):
    """Fused fetch (the default) into a tumbling event-time window of
    one second; the input topic replicated over three brokers (the
    replication fan-out is ``delay_many``'s cohort), one of them a slow
    host for a while (``extra_s``)."""
    spec = core.PipelineSpec(delivery="poll")
    spec.add_switch("s1")
    for h in ["b", "b2", "b3", "p1", "p2", "w", "c"]:
        spec.add_host(h).add_link(h, "s1", lat=1.0, bw=1000.0)
    for b in ("b", "b2", "b3"):
        spec.add_broker(b)
    spec.add_topic("in", leader="b", partitions=2, replication=3)
    spec.add_topic("agg", leader="b")
    spec.add_fault(1.0, "slow_host", "b2", duration=10.0, delay_s=0.02)
    for p in ("p1", "p2"):
        spec.add_producer(p, "SYNTHETIC", topics=["in"], rateKbps=80.0,
                          msgSize=200, totalMessages=150, etJitterS=0.3)
    spec.add_spe("w", query="identity", inTopic="in", outTopic="agg",
                 timeMode="event", window=1.0, allowedLateness=0.2,
                 keyField="src", agg="count", pollInterval=0.5)
    spec.add_consumer("c", "METRICS", topic="agg", pollInterval=0.1)
    return spec


def test_engine_metrics_equal_under_both_backends(monkeypatch):
    """The same spec and seed give the same ``Engine.metrics()`` (wall
    times aside) and sink payloads with both variables at ``torch:cpu``
    as with numpy, and the torch backends did run."""
    import repro_torch.core as core

    def run():
        eng = core.Engine(_window_spec(core), seed=5)
        eng.run(until=30.0)
        m = {k: v for k, v in eng.metrics().items()
             if k not in ("wall_s", "profile_wall")}
        sinks = [p for rt in eng.runtimes for p in getattr(rt, "payloads",
                                                           [])]
        return m, sinks, eng.n_events

    want = run()
    calls = {"pane": 0, "delay": 0, "extra": 0}
    for mod, name, tag in ((cohort, "_pane_starts_torch", "pane"),
                           (netcalc, "_delay_many_torch", "delay")):
        fn = getattr(mod, name)

        def counted(*a, fn=fn, tag=tag):
            calls[tag] += 1
            calls["extra"] += tag == "delay" and a[3] is not None
            return fn(*a)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setenv("REPRO_COHORT_BACKEND", "torch:cpu")
    monkeypatch.setenv("REPRO_NETCALC_BACKEND", "torch:cpu")
    got = run()
    assert calls["pane"] and calls["delay"] and calls["extra"], calls
    assert got[0] == want[0]
    assert got[1] and got[1] == want[1]
    assert got[2] == want[2]


@pytest.mark.parametrize("fn", ["pane_starts", "delay_many"])
def test_torch_backend_without_a_gpu_raises(monkeypatch, fn):
    """``torch`` computes on cuda: with no GPU it raises (no fallback to
    the CPU or to numpy), and so does a torch value naming no backend."""
    import torch
    x = CASES["seeded"]
    var = {"pane_starts": "REPRO_COHORT_BACKEND",
           "delay_many": "REPRO_NETCALC_BACKEND"}[fn]

    def call():
        if fn == "pane_starts":
            return cohort.pane_starts(x["ets"], 0.7)
        return netcalc.delay_many(x["lat"], x["bw"], 1500, None)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(var, "torch")
    with pytest.raises(RuntimeError, match="no GPU"):
        call()
    monkeypatch.setenv(var, "torch:gpu")
    with pytest.raises(ValueError, match="not a torch backend"):
        call()
