"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

Each side runs its own ``run_cell`` in a subprocess on the cell that
``tests/test_dryrun_small.py`` builds, qwen2-7b at smoke size on a (2, 4)
``("data", "model")`` mesh, for the train, prefill and decode bundles
(seq 64, batch 8): the reference lowers and compiles on 8 forced host
devices, on a ``jax.sharding.Mesh`` of ``Auto`` axes (ROADMAP C8), and
prices the HLO; the port traces rank 0 of a fake process group of 8
ranks on fake tensors.  Both write the JSON artifact.

(a) Per-device FLOPs.  Both count the same products: the reference its
    ``dot`` ops, the port the matmul family and the kernels' operators,
    which count every (query, key) pair as the reference's plain
    attention does.  Prefill and decode run the same products, so the
    counts must be equal.  The train step runs two recomputes that the
    reference's compiled program does not: the attention backward
    operator recomputes the forward's two products (a third of its
    formula; XLA keeps the probabilities), and the loss chunks are
    checkpointed, so their logits product runs again in the backward
    (XLA keeps the logits).  The port's count must equal the
    reference's plus those two, computed here from the cell's shapes:
    the tolerance is zero.
(b) Collectives.  The port's records equal the ring model of
    ``roofline._collective_record`` applied to the collectives the port
    issues, as logged at the ``torch.distributed`` calls (independently
    of the recorder, which sees the dispatched operators).  They are
    printed beside the reference's; they are not held equal, since XLA
    chooses its own collectives.
(c) The JSON keys, nested, equal the reference's; the port's null keys
    are the ones it cannot measure, listed in ``NULL_KEYS``.
(d) One production cell end to end: qwen2-7b train_4k on the 256-rank
    fake 16x16 mesh, through the command line, with neither ``jax`` nor
    ``repro`` loaded (the acceptance command).
(e) The trace against a real run: on the (1, 1) mesh of one gloo rank,
    the FLOPs traced on fake meta tensors (the card's path) equal the
    FLOPs ``FlopCounterMode`` counts when the same prefill and decode
    bundles run on real CPU tensors (the plain path, which runs the same
    products: every (query, key) pair), as phase (l) of
    ``chip_smoke.py`` holds them against a run on real CUDA tensors.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

KINDS = ("train", "prefill", "decode")
NULL_KEYS = {"compile_s", "cost_analysis",
             "memory_analysis.temp_size_in_bytes",
             "memory_analysis.generated_code_size_in_bytes"}

COMMON = """
import dataclasses, json, sys
SHAPES = {kind: ShapeCfg(kind, 64, 8, kind)
          for kind in ("train", "prefill", "decode")}
smoke = reduce_for_smoke(get_config("qwen2-7b"))
overrides = {f.name: getattr(smoke, f.name)
             for f in dataclasses.fields(smoke)}
dr.SHAPES = SHAPES
"""

REF = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
jax.devices()          # 8 devices, before the dry run asks for 512
import repro.launch.dryrun as dr
from repro.configs import get_config, reduce_for_smoke
from repro.configs.base import ShapeCfg
""" + COMMON + """
dr.make_production_mesh = lambda multi_pod=False: Mesh(
    np.array(jax.devices()).reshape(2, 4), ("data", "model"),
    axis_types=(AxisType.Auto,) * 2)
out = {kind: dr.run_cell("qwen2-7b", kind, out_dir=sys.argv[1],
                         overrides=overrides) for kind in SHAPES}
print(json.dumps(out))
"""

PORT = """
import torch.distributed as dist
import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch.mesh import make_mesh
""" + COMMON + """
start = dr.fake_process_group
dr.fake_process_group = lambda world_size: start(8)
dr.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
api, records = [], []


def logged(name, fn, ins, outs):
    def call(*a, **k):
        group = k.get("group")
        ranks = dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)
        nbytes = lambda i: a[i].numel() * a[i].element_size()
        api[-1].append((name, nbytes(ins), nbytes(outs), ranks))
        return fn(*a, **k)
    return call


for name, ins, outs in (("all_reduce", 0, 0),
                        ("all_gather_into_tensor", 1, 0),
                        ("reduce_scatter_tensor", 1, 0),
                        ("all_to_all_single", 1, 0)):
    setattr(dist, name, logged(name, getattr(dist, name), ins, outs))
trace = dr.trace_program


def traced(*a, **k):
    analysis, out, rec = trace(*a, **k)
    records[-1] += [dataclasses.asdict(c) for c in rec.collectives]
    return analysis, out, rec


dr.trace_program = traced
out = {}
for kind in SHAPES:
    api.append([])
    records.append([])
    out[kind] = dr.run_cell("qwen2-7b", kind, out_dir=sys.argv[1],
                            overrides=overrides)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"cells": out, "api": dict(zip(SHAPES, api)),
                  "records": dict(zip(SHAPES, records)),
                  "loaded": loaded}))
"""


def _run(code, out_dir, timeout, *, jax_platform=True):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    if jax_platform:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, str(out_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    return _run(REF, tmp_path_factory.mktemp("ref"), 600)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _run(PORT, tmp_path_factory.mktemp("port"), 300)


def recomputes(cfg, B=8, S=64, data=2, model=4) -> int:
    """The FLOPs of the two recomputes the port's train step runs and the
    reference's compiled step does not (see the module doc), per device:
    every layer's attention forward products in its backward operator,
    and every loss chunk's logits product."""
    k = cfg.microbatches
    rows = B // data // k                         # per microbatch
    heads = cfg.n_heads // model                  # split by the TP plan
    attn = 4 * rows * heads * S * S * cfg.head_dim_
    n_chunks = max(1, S // 512)                   # Model.loss seq_chunk
    logits = 2 * rows * S * cfg.d_model * (cfg.vocab_size // model)
    layers = sum(layer.mixer in ("attn", "attn_local")
                 for layer in cfg.pattern) * cfg.n_layers // len(
                     cfg.pattern)
    assert n_chunks == 1
    return k * (layers * attn + logits)


@pytest.mark.parametrize("kind", KINDS)
def test_flops_per_device_match_the_reference(ref_cells, port_run, kind):
    from repro_torch.configs import get_config, reduce_for_smoke
    want, got = ref_cells[kind], port_run["cells"][kind]
    assert want["status"] == got["status"] == "OK", (want, got)
    ref_flops = want["hlo_analysis"]["flops_per_device"]
    port_flops = got["hlo_analysis"]["flops_per_device"]
    extra = recomputes(reduce_for_smoke(get_config("qwen2-7b"))) \
        if kind == "train" else 0
    assert ref_flops > 0
    assert port_flops == ref_flops + extra, (port_flops, ref_flops, extra)
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got["n_chips"] == want["n_chips"] == 8


def _ring(kind, operand, result, n):
    """``repro.analysis.roofline._collective_record``'s moved bytes."""
    if kind == "all_reduce":
        return 2.0 * operand * (n - 1) / max(n, 1)
    if kind == "all_gather_into_tensor":
        return result * (n - 1) / max(n, 1)
    return operand * (n - 1) / max(n, 1)


HLO_KIND = {"all_reduce": "all-reduce", "all_gather_into_tensor":
            "all-gather", "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all"}


@pytest.mark.parametrize("kind", KINDS)
def test_collective_records_are_the_ring_model_of_the_calls(
        ref_cells, port_run, kind):
    calls, records = port_run["api"][kind], port_run["records"][kind]
    assert len(records) == len(calls) > 0
    ici = 0.0
    for (name, operand, result, ranks), rec in zip(calls, records):
        assert rec["kind"] == HLO_KIND[name]
        assert rec["operand_bytes"] == operand
        assert rec["group_size"] == len(ranks)
        assert rec["moved_bytes"] == _ring(name, operand, result,
                                           len(ranks))
        assert rec["crosses_pod"] is False        # 8 ranks, one pod
        ici += rec["moved_bytes"]
    got = port_run["cells"][kind]["hlo_analysis"]
    assert got["ici_bytes_per_device"] == ici
    assert got["dcn_bytes_per_device"] == 0.0
    want = ref_cells[kind]["hlo_analysis"]
    top = [(c["kind"], c["group_size"], c["moved_bytes"])
           for c in want["top_collectives"]]
    print(f"\n{kind}: port ici {ici:.0f} B in {len(records)} collectives "
          f"{sorted({(r['kind'], r['group_size']) for r in records})}; "
          f"reference ici {want['ici_bytes_per_device']:.0f} B, top {top}")


def _keys(d: dict, prefix="") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "cost_analysis":
            out |= _keys(v, prefix + k + ".")
    return out


def _nulls(d: dict, prefix="") -> set:
    out = set()
    for k, v in d.items():
        if v is None:
            out.add(prefix + k)
        elif isinstance(v, dict):
            out |= _nulls(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_json_keys_equal_the_reference(ref_cells, port_run, kind):
    want, got = ref_cells[kind], port_run["cells"][kind]
    assert _keys(got) == _keys(want)
    assert _nulls(got) == NULL_KEYS
    assert not _nulls(want)
    for key in ("top_collectives", "top_dots"):
        assert len(got["hlo_analysis"][key]) <= 12


def test_port_loads_neither_jax_nor_repro(port_run):
    assert port_run["loaded"] == []


CLI = """
import json, runpy, sys
sys.argv = ["dryrun", "--arch", "qwen2-7b", "--shape", "train_4k",
            "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps({"code": code, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "repro"))}))
"""


def test_production_cell_end_to_end_on_256_fake_ranks(tmp_path, ref_cells):
    r = _run(CLI, tmp_path, 240, jax_platform=False)
    assert r == {"code": 0, "loaded": []}
    cell = json.loads((tmp_path / "qwen2-7b__train_4k__16x16.json")
                      .read_text())
    assert cell["status"] == "OK" and cell["n_chips"] == 256
    assert cell["hlo_analysis"]["flops_per_device"] > 0
    assert cell["hlo_analysis"]["ici_bytes_per_device"] > 0
    assert _keys(cell) == _keys(ref_cells["train"])
    assert cell["roofline"]["bottleneck"] in ("compute", "memory", "ici",
                                              "dcn")


ONE_RANK = """
import json, os, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.analysis.program import card_trace, trace_program
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed.sharding import distribute
from repro_torch.launch.dryrun import step_inputs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.train import make_step_bundle
from repro_torch.train.steps import place_params
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(sys.argv[1], "store"), 1), rank=0, world_size=1)
cfg = reduce_for_smoke(get_config("qwen2-7b"))
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
model = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
out = {}
for kind in ("prefill", "decode"):
    b = make_step_bundle(cfg, ShapeCfg(kind, 64, 2, kind), mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), card_trace("meta"):
        traced = trace_program(b.step_fn, *step_inputs(b, "meta"))[0]
    params = place_params(cfg, {k: p.detach() for k, p in
                                model.named_parameters()}, b.in_shardings[0])
    if kind == "prefill":
        args = (params, torch.randint(0, cfg.vocab_size, (2, 64)))
    else:
        cache = [{n: {"mixer": {k: distribute(t, b.in_shardings[1][i][n][
            "mixer"][k]) for k, t in lc["mixer"].items()}}
            for n, lc in g.items()}
            for i, g in enumerate(model.init_cache(2, 64, torch.float32))]
        args = (params, cache, torch.randint(0, cfg.vocab_size, (2, 1)), 63)
    with FlopCounterMode(display=False) as fc:
        b.step_fn(*args)
    out[kind] = [traced.flops, fc.get_total_flops()]
print(json.dumps(out))
"""


def test_traced_flops_equal_a_real_run_on_one_rank(tmp_path):
    got = _run(ONE_RANK, tmp_path, 240, jax_platform=False)
    for kind, (traced, real) in got.items():
        assert traced == real > 0, kind
