"""BENCHMARK.json against the files it names and the contract's limits;
a traffic mix and a metric added as new files are found by name."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

import smoke
from benchlib.spec import Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def doc():
    return json.loads((smoke.ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_limits(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["cardbench"] and 1 <= doc["run_seconds"] <= 51
    assert doc["command"][:2] == ["python3", "cardbench/run.py"]
    names = set()
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert c["file"].startswith("cardbench/") and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (smoke.ROOT / c["file"]).is_file()
        names.add(c["name"])
    cells = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    metrics = doc["end_to_end"] + doc["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(doc)) < 64 * 1024


def test_every_cell_finds_its_files(bench, doc):
    for w in doc["workloads"]:
        cell = bench.cell(w["name"])
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(bench.metric_reader(m).read)
        ref = bench.reference(w["config"])
        for entry in ("train_loss", "prefill", "extend"):
            assert callable(getattr(ref, entry))
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_configuration_files_match_the_port(bench, doc):
    from benchlib import port
    for c in doc["configs"]:
        cfg = bench.config_file(c["name"])
        arch = port.arch_config(cfg)
        assert arch.name == cfg["arch"]
        if "optimizer" in cfg:
            port.check_optimizer(arch, cfg["optimizer"])


def test_new_mix_and_metric_are_found_by_name(tmp_path, doc):
    """A later change adds a cell as files and entries only: a traffic mix,
    its limits and a per-layer metric, read by the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(smoke.BENCH, root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(doc)
    new["workloads"] = doc["workloads"] + [{
        "name": "qwen2-7b.prefill-short", "config": "qwen2-7b",
        "traffic": "prefill-short", "chips": 1, "why": "short prompts"}]
    new["per_layer"] = doc["per_layer"] + [{
        "name": "busy_ms.prefill-short", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "prefill_tokens_per_s",
        "workloads": ["qwen2-7b.prefill-short"]}]
    for m in new["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"] = m["workloads"] + ["qwen2-7b.prefill-short"]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    (root / "cardbench/traffic/prefill-short.json").write_text(json.dumps({
        "kind": "prefill",
        "lengths": {"min": 1024, "max": 2048, "count": 4, "multiple": 64}}))
    (root / "cardbench/limits/qwen2-7b.prefill-short.json").write_text(
        json.dumps({"logit_err": 1e-3, "kv_err": 1e-3, "token_mismatch": 0,
                    "flash_attention_launch_gap": 0}))
    (root / "cardbench/metrics/busy_ms.prefill-short.py").write_text(
        "def read(r):\n    return 1e3 * r.window_s / max(r.units, 1)\n")
    code = f"""
import sys, json, time
sys.path[:0] = [{str(root / 'cardbench')!r}, {str(smoke.ROOT / 'src')!r},
                {str(root / 'cardbench' / 'tests')!r}]
import smoke
from benchlib.spec import Benchmark
from benchlib import harness
bench = Benchmark({str(root)!r})
cell = bench.cell("qwen2-7b.prefill-short")
assert cell.traffic["lengths"]["max"] == 2048
assert cell.per_layer == ("busy_ms.prefill-short",)
smoke.TRAFFIC["prefill"] = {{"lengths": {{"min": 16, "max": 32, "count": 2,
                                          "multiple": 8}}}}
run = smoke.smoke_run(bench, "qwen2-7b.prefill-short", 9)
res = harness.run_cell(bench, run, 0.2, True, time.perf_counter())
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and "busy_ms.prefill-short" in res["metrics"]
