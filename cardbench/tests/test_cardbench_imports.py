"""What the benchmark loads: no JAX and no JAX package anywhere, and in
the reference nothing of the program either (top-level names compared
whole: ``repro_torch`` is not ``repro``)."""
import json
import subprocess
import sys

import smoke

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str):
    """The JSON of the last line that ``code`` prints, run in a fresh
    interpreter with the harness and the port on its path."""
    full = f"""
import sys, json
sys.path[:0] = [{str(smoke.BENCH)!r}, {str(smoke.ROOT / 'src')!r}]
{code}
"""
    out = subprocess.run([sys.executable, "-c", full], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _modules(code: str) -> set:
    return set(_python(code + """
print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))
"""))


def test_harness_loads_no_jax():
    mods = _modules("""
import run
from benchlib import harness
from benchlib.spec import Benchmark
b = Benchmark(run.ROOT)
for w in b.doc["workloads"]:
    cell = b.cell(w["name"])
    harness.make_run(b, w["name"], 1, "cpu")
    for m in cell.per_layer:
        b.metric_reader(m)
for kind in ("train", "prefill", "decode"):
    harness.loop_for(kind)
import control
""")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules("""
import importlib.util, pathlib
for f in sorted(pathlib.Path({0!r}).glob("*.py")):
    spec = importlib.util.spec_from_file_location(
        "ref_" + f.stem.replace("-", "_"), f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
""".format(str(smoke.BENCH / "reference")))
    assert not mods & (FORBIDDEN | {"repro_torch", "benchlib"}), mods


def test_forbidden_names_are_compared_whole():
    """In a fresh interpreter, so that what other tests of the process
    imported (the JAX package among them) is not in ``sys.modules``."""
    clean, like, whole = _python("""
import run
clean = run.forbidden_modules()
sys.modules["repro_torch_like"] = sys.modules["json"]
sys.modules["jaxtyping"] = sys.modules["json"]
like = run.forbidden_modules()
sys.modules["repro.core"] = sys.modules["json"]
print(json.dumps([clean, like, run.forbidden_modules()]))
""")
    assert clean == [] and like == []
    assert whole == ["repro"]
