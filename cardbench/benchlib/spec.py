"""``BENCHMARK.json`` and the data files it names, found by name."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent      # cardbench/


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict            # configs/<config>.json, with "name"
    traffic: dict           # traffic/<traffic>.json, with "name"
    chips: int
    limits: dict            # limits/<cell>.json: {number: limit}
    end_to_end: tuple       # the end-to-end metrics this cell reports
    per_layer: tuple        # the per-layer metrics this cell reports


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e: tuple) -> bool:
    """A per-layer metric with ``workloads`` is reported in those cells;
    one without, in every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


class Benchmark:
    """``BENCHMARK.json`` at ``root``, with the harness's files under
    ``bench_dir`` (both found beside this file unless given: tests point
    them at a copy)."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.doc = read_json(self.root / "BENCHMARK.json")
        self.units = {m["name"]: m["unit"] for m in
                      self.doc["end_to_end"] + self.doc["per_layer"]}

    def config_file(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                cfg = read_json(self.root / c["file"])
                return dict(cfg, name=name)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{[w['name'] for w in self.doc['workloads']]}")
        e2e = tuple(m["name"] for m in self.doc["end_to_end"]
                    if "workloads" not in m or name in m["workloads"])
        per_layer = tuple(m["name"] for m in self.doc["per_layer"]
                          if _reports(m, name, e2e))
        traffic = dict(read_json(self.dir / "traffic" /
                                 f"{w['traffic']}.json"), name=w["traffic"])
        return Cell(name, self.config_file(w["config"]), traffic,
                    int(w["chips"]),
                    read_json(self.dir / "limits" / f"{name}.json"),
                    e2e, per_layer)

    def metric_reader(self, name: str):
        """``metrics/<name>.py``: a module with ``read(reading)`` and
        optionally ``SPANS`` (see ``tracing.Spans``)."""
        return load_module(self.dir / "metrics" / f"{name}.py",
                           f"cardbench_metric_{name}")

    def reference(self, config: str):
        """``reference/<config>.py``, the configuration's plain
        reference."""
        return load_module(self.dir / "reference" / f"{config}.py",
                           f"cardbench_reference_{config}")


def load_module(path: Path, name: str):
    """Import a file whose name need not be an identifier (``mfu.train``,
    ``qwen2-7b``)."""
    name = "".join(ch if ch.isalnum() else "_" for ch in name)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod
