"""The port's copy of the sweep subsystem against the JAX package's.

``repro_torch.sweep`` is a copy of ``repro.sweep`` with its imports
rewritten.  Both packages expand the same ``SweepSpec`` and run it on
their own engines under the same seeds; ROADMAP C3's contract holds
between the two runs: every non-wall metric is equal, ints and strings
exactly, floats allclose at rtol = atol = 1e-6.  The trace CLI's demo
export of ``repro_torch.obs.trace`` gives the reference's bytes.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import trace as jtrace
from repro.sweep import SweepSpec as JSweepSpec, run_sweep as jrun_sweep
from repro.sweep import shutdown_pool as jshutdown
from repro_torch.obs import trace
from repro_torch.sweep import (
    SweepResults, SweepSpec, TIMING_KEYS, run_sweep, scenario_id,
    shutdown_pool,
)

ROOT = Path(__file__).resolve().parent.parent
C3_RTOL = 1e-6

BASE = {"topology": "star", "n_brokers": 1, "n_topics": 2, "n_producers": 2,
        "rate_kbps": 16.0, "horizon": 6.0, "seed": 0}
AXES = {"n_hosts": [6, 8], "delivery": ["poll", "wakeup"],
        "windowed": [0, 1]}


def same_builder(params):
    """A module-level builder both packages' specs can name: the port's
    default builder, so each package hashes the same reference."""
    from repro_torch.sweep import build_scenario
    return build_scenario(params)


@pytest.fixture(autouse=True)
def _no_pools():
    yield
    shutdown_pool()
    jshutdown()


def assert_c3(got, want, path="metrics"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_c3(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_c3(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, float), path
        assert math.isclose(got, want, rel_tol=C3_RTOL, abs_tol=C3_RTOL) \
            or (math.isnan(got) and math.isnan(want)), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_same_spec_same_scenarios():
    """Same params in the same order.  A scenario id hashes the builder's
    import path with the params (``grid.py``), so the default builders'
    ids differ by package, which keeps the two packages' result caches
    apart; with one builder named by both, the ids are equal."""
    ours = SweepSpec("t", AXES, BASE).scenarios()
    ref = JSweepSpec("t", AXES, BASE).scenarios()
    assert len(ours) == len(ref) == 8
    assert [s.params for s in ours] == [s.params for s in ref]
    assert [s.id for s in SweepSpec("t", AXES, BASE,
                                    builder=same_builder).scenarios()] == \
        [s.id for s in JSweepSpec("t", AXES, BASE,
                                  builder=same_builder).scenarios()]
    assert [s.id for s in ours] == [scenario_id(s.params, s.builder)
                                    for s in ours]
    assert len({s.id for s in ours}) == 8


@pytest.mark.parametrize("workers", [1, 2])
def test_run_sweep_matches_reference(workers):
    """Inline (workers=1) and on the warm forkserver pool (workers=2)."""
    ours = run_sweep(SweepSpec("t", AXES, BASE), workers=workers)
    ref = jrun_sweep(JSweepSpec("t", AXES, BASE), workers=workers)
    assert [r["params"] for r in ours] == [r["params"] for r in ref]
    for a, b in zip(ours, ref):
        got = {k: v for k, v in a["metrics"].items() if k not in TIMING_KEYS}
        want = {k: v for k, v in b["metrics"].items() if k not in TIMING_KEYS}
        assert_c3(got, want)
    # the windowed SPE ran in half of the scenarios
    assert ours.column("windows_fired").max() > 0


def test_warm_workers_import_neither_torch_jax_nor_repro():
    """In a process that runs only the port (a fresh interpreter: the
    fork server is one per process, so a pytest worker that ran the
    reference's sweep first would hand its preload to every later pool),
    the warm workers fork from a template that imported neither torch,
    JAX nor ``repro``."""
    code = (
        "from repro_torch.sweep import SweepSpec, run_sweep, warm_pool\n"
        "from repro_torch.sweep.runner import _worker_probe\n"
        "if __name__ == '__main__':\n"
        f"    run_sweep(SweepSpec('t', {{'n_hosts': [6, 8]}}, {BASE!r}),\n"
        "              workers=2)\n"
        "    probes = warm_pool(2).map(_worker_probe, range(8))\n"
        "    bad = [p for p in probes if p['torch_loaded'] or "
        "p['jax_loaded'] or p['repro_loaded']]\n"
        "    print('PROBES', len(probes), 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PROBES 8 BAD []" in out.stdout


def test_results_save_load_roundtrip(tmp_path):
    res = run_sweep(SweepSpec("t", {"n_hosts": [6, 8]}, BASE), workers=1)
    path = str(tmp_path / "res.json")
    res.save_json(path)
    back = SweepResults.load_json(path)
    assert back.name == "t" and len(back) == 2
    assert back.fingerprint() == res.fingerprint()
    assert back.table() == res.table()


def test_demo_trace_equals_reference(tmp_path):
    """The demo export (geo-WAN, chaos, telemetry) at a short horizon:
    the same Chrome trace, byte for byte, and a valid one."""
    ours, ref = tmp_path / "port.json", tmp_path / "ref.json"
    assert trace.main([str(ours), "--horizon", "3.0"]) == 0
    assert jtrace.main([str(ref), "--horizon", "3.0"]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert trace.main([str(ours), "--validate"]) == 0
    assert json.loads(ours.read_text())["traceEvents"]
