"""LM serving through the gym, port against reference, and the port's
import hygiene.

The serve spec of ``launch/serve.py`` (qwen2-7b and the default
xlstm-125m, at smoke size, float32) runs in both packages under the same
seed, with the reference's
parameters injected into the port's query.  The generated token lists
and every non-wall ``Engine.metrics()`` field must be equal: both runs
are live, never the pinned metrics of ``tests/test_metrics_pin.py``
(ROADMAP C2).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.core import Engine as JEngine
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch.core import Engine
from repro_torch.core.spe import LMGenerateQuery
from repro_torch.launch import serve
from repro_torch.models.params import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
WALL_KEYS = ("wall_s", "profile_wall")


def serve_args(**kw):
    a = dict(arch="xlstm-125m", requests=3, batch=3, seq=12, gen=5,
             interval=0.5, lat=1.0, bw=1000.0, mode="kraft", seed=0,
             device="cpu", full=False)
    a.update(kw)
    return SimpleNamespace(**a)


def generations(sink_rt):
    return [(p["data"] if "data" in p else p)["generated"]
            for p in sink_rt.payloads]


def run(engine_cls, build_spec, args):
    spec, sink = build_spec(args)
    eng = engine_cls(spec, seed=args.seed)
    eng.run(until=args.requests * args.interval + 30.0)
    return eng, [rt for rt in eng.runtimes if rt.name == sink.name][0]


@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-125m"])
def test_gym_serve_matches_reference(monkeypatch, arch):
    """batch 3 is bucket-padded to 4 on both sides (jit_bucket)."""
    def jax_params(self, model):
        tree = JModel(jreduce(jget(arch))).init_params(
            jax.random.key(0))     # what the reference query draws
        model.load_state_dict(from_jax_params(
            model.cfg, jax.tree.map(np.asarray, tree)))

    monkeypatch.setattr(LMGenerateQuery, "_init_params", jax_params)
    args = serve_args(arch=arch)
    jeng, jsink = run(JEngine, jserve.build_spec, args)
    teng, tsink = run(Engine, serve.build_spec, args)
    want = generations(jsink)
    assert len(want) == args.requests
    assert np.asarray(want).shape == (args.requests, args.batch, args.gen)
    assert generations(tsink) == want
    jm = {k: v for k, v in jeng.metrics().items() if k not in WALL_KEYS}
    tm = {k: v for k, v in teng.metrics().items() if k not in WALL_KEYS}
    assert tm == jm


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--seq", "8",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert "xlstm-125m: 2/2 responses" in out


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def _banned(module: str) -> bool:
    return module.split(".")[0] in ("jax", "repro", "jaxlib")


def port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_distribution_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in port_files()[:-1]}
    assert {"distributed/sharding.py", "launch/mesh.py",
            "optim/compress.py", "train/steps.py",
            "runtime/driver.py"} <= names


def test_scan_covers_the_analysis_and_the_dry_run():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in port_files()[:-1]}
    assert {"analysis/__init__.py", "analysis/roofline.py",
            "analysis/program.py", "launch/dryrun.py"} <= names


def _run_python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_runs_without_loading_jax_or_repro():
    out = _run_python(
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.launch import serve\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.optim.compress, repro_torch.runtime\n"
        "eng, sink = serve.run(serve.parse_args(['--device', 'cpu', "
        "'--requests', '1', '--seq', '8', '--gen', '2']))\n"
        "assert sink.n_received == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")
    assert "LOADED []" in out


def test_kernel_modules_import_without_nvcc_or_triton():
    out = _run_python(
        "import subprocess, sys\n"
        "sys.modules['triton'] = None\n"
        "class NoNvcc(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        assert 'nvcc' not in str(args), 'nvcc ran'\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = NoNvcc\n"
        "import torch\n"
        "from repro_torch.kernels import _build, ops, ref\n"
        "from repro_torch.kernels import flash_attention, flash_decode\n"
        "import repro_torch.models, repro_torch.core.spe\n"
        "q = torch.zeros(1, 8, 2, 16)\n"
        "ops.flash_attention(q, q, q, 0.25)\n"
        "ops.flash_decode(q[:, 0], q, q, 3, scale=0.25)\n"
        "assert not _build._libs\n"
        "print('OK', flash_attention.launches, flash_decode.launches)\n")
    assert "OK 0 0" in out


def test_emulator_imports_without_torch():
    """``repro_torch.core`` and ``repro_torch.sweep`` import torch only
    inside query bodies (the emulator's import contract, ROADMAP "Import
    hygiene"), and the sweep's fork-server preload imports neither torch,
    JAX nor ``repro``."""
    out = _run_python(
        "import sys\n"
        "import repro_torch.core, repro_torch.core.spe\n"
        "from repro_torch.kernels import cohort, netcalc\n"
        "import repro_torch.sweep, repro_torch.obs\n"
        "from repro_torch.sweep.runner import _PRELOAD\n"
        "assert _PRELOAD == ['repro_torch.sweep.runner'], _PRELOAD\n"
        "for name in _PRELOAD:\n"
        "    __import__(name)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'jax', 'jaxlib', 'repro'})\n"
        "print('LOADED', bad)\n")
    assert "LOADED []" in out
