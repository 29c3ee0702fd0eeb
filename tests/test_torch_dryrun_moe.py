"""The port's dry run against the reference's for the MoE archs and the
cells of ROADMAP C17 and C19.

The harness of ``tests/test_torch_dryrun.py`` (smoke size, seq 64, batch
8, a (2, 4) ``("data", "model")`` mesh: the reference compiled on 8
forced host devices, the port traced as rank 0 of 8 fake ranks), widened
to more cells, each side pricing all of them in one subprocess:

- granite-moe-3b-a800m, jamba-v0.1-52b and llama4-maverick-400b-a17b
  (4 experts at smoke size, no ``ep_shard``), train, prefill and decode:
  the tensor-parallel plan splits the experts over ``model`` ("expert",
  one a rank) and llama4's shared expert ("shared"); the (E, C, D)
  buffer's capacity splits over ``data`` where it divides, as the
  reference's partitioner splits it (``repro/models/moe.py:113, :124``);
- musicgen-large and pixtral-12b, train (fed embeddings: C17);
- xlstm-125m, train, prefill and decode (C19).

Each cell's per-device FLOPs are held at the reference's plus terms
computed from the cell's shapes, at zero tolerance.  Prefill and decode
run the same products on both sides: no term.  The train step has:

- the two recomputes of ``tests/test_torch_dryrun.py`` (``recomputes``:
  the attention backward's forward products and the loss chunks' logits
  product), which the port runs and XLA does not;
- the products whose contraction has length 1, which the port's
  autograd runs as batched matrix products and XLA rewrites into
  multiplies, which the reference's count (its ``dot`` ops) leaves out
  (``outer_products``): the router's input gradient where a rank holds
  one expert, the gradient of mamba's state readout (h @ C) with
  respect to the state, and the gradient of the mLSTM's normaliser
  readout (q . n) with respect to q;
- the gradients through a recurrent layer's initial (zero) state, which
  XLA's scan computes for its first step and the port's autograd does
  not (the zeros need none: ``initial_state_grads``, subtracted): the
  mLSTM's initial matrix memory through the first chunk's inter-chunk
  product, and the sLSTM's initial hidden state through its first
  step's recurrent product.

Where these come from was found by comparing, product by product, the
port's traced operator list (``launch/dryrun.py --save-hlo``) with the
reference's HLO ``dot`` ops (ROADMAP C19).  The port's plan for each MoE
cell is checked too.
"""
import json
import os
import subprocess
import sys

import pytest

from test_torch_dryrun import recomputes

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

MOE = ("granite-moe-3b-a800m", "jamba-v0.1-52b", "llama4-maverick-400b-a17b")
KINDS = ("train", "prefill", "decode")
CELLS = ([(a, k) for a in MOE for k in KINDS]
         + [("musicgen-large", "train"), ("pixtral-12b", "train")]
         + [("xlstm-125m", k) for k in KINDS])
DATA, MODEL = 2, 4
B, S = 8, 64
# the kinds of the port's plan at (2, 4) for the MoE cells
PLANS = {"granite-moe-3b-a800m": {"heads", "kv_heads", "vocab", "expert"},
         "jamba-v0.1-52b": {"heads", "kv_heads", "ffn", "mamba", "vocab",
                            "expert"},
         "llama4-maverick-400b-a17b": {"heads", "kv_heads", "ffn", "vocab",
                                       "expert", "shared"}}

COMMON = """
import dataclasses, json, sys
SHAPES = {kind: ShapeCfg(kind, 64, 8, kind)
          for kind in ("train", "prefill", "decode")}
dr.SHAPES = SHAPES
CELLS = json.loads(sys.argv[2])


def smoke(arch):
    cfg = reduce_for_smoke(get_config(arch))
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
"""

REF = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
jax.devices()
import repro.launch.dryrun as dr
from repro.configs import get_config, reduce_for_smoke
from repro.configs.base import ShapeCfg
""" + COMMON + """
dr.make_production_mesh = lambda multi_pod=False: Mesh(
    np.array(jax.devices()).reshape(2, 4), ("data", "model"),
    axis_types=(AxisType.Auto,) * 2)
out = {f"{a}:{k}": dr.run_cell(a, k, out_dir=sys.argv[1],
                               overrides=smoke(a)) for a, k in CELLS}
print(json.dumps(out))
"""

PORT = """
import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch.mesh import make_mesh
""" + COMMON + """
start = dr.fake_process_group
dr.fake_process_group = lambda world_size: start(8)
dr.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
kinds, bundle = {}, dr.make_step_bundle


def make_step_bundle(cfg, shape, mesh):
    b = bundle(cfg, shape, mesh)
    kinds[cfg.name] = sorted(b.tp.kinds)
    return b


dr.make_step_bundle = make_step_bundle
out = {f"{a}:{k}": dr.run_cell(a, k, out_dir=sys.argv[1],
                               overrides=smoke(a)) for a, k in CELLS}
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"cells": out, "kinds": kinds, "loaded": loaded}))
"""


def _run(code, out_dir, timeout, *, jax_platform=True):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    if jax_platform:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, str(out_dir),
                          json.dumps(CELLS)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    return _run(REF, tmp_path_factory.mktemp("ref"), 600)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _run(PORT, tmp_path_factory.mktemp("port"), 600,
                jax_platform=False)


def _count(cfg, mixer=None, ffn=None) -> int:
    """Layers of the whole model with ``mixer`` (or ``ffn``)."""
    per = sum(1 for layer in cfg.pattern
              if (mixer is None or layer.mixer == mixer)
              and (ffn is None or layer.ffn == ffn))
    return per * cfg.n_layers // len(cfg.pattern)


def outer_products(cfg, model=MODEL) -> int:
    """Per device, in the train step's backward: the products of
    contraction length 1 that the port counts and the reference's HLO
    does not (each 2 x its output's elements)."""
    T = B // DATA * S                   # the rank's tokens of a step
    n = 0
    if cfg.moe is not None and cfg.moe.padded_experts() // model == 1:
        # the router's logits (T, 1) of the rank's one expert: their
        # gradient times the router's column, (T, 1) x (1, D)
        n += _count(cfg, ffn="moe") * 2 * T * cfg.d_model
    if cfg.mamba is not None:
        # y = h @ C per token, h (d_inner / m, d_state): dy x C^T
        n += (_count(cfg, mixer="mamba") * 2 * T
              * (cfg.d_inner_mamba // model) * cfg.mamba.d_state)
    if any(layer.mixer == "mlstm" for layer in cfg.pattern):
        # the normaliser q . n per (row, head, position): dden x n^T
        heads = cfg.n_heads // model
        dh = cfg.d_inner_mlstm // cfg.n_heads
        n += _count(cfg, mixer="mlstm") * 2 * T * heads * dh
    return n


def initial_state_grads(cfg, model=MODEL) -> int:
    """Per device, in the train step's backward: the products that carry
    the gradient into a recurrent layer's initial state, which the
    reference's scan computes and the port's autograd does not."""
    rows = B // DATA                    # the rank's rows of a step
    n = 0
    if any(layer.mixer == "mlstm" for layer in cfg.pattern):
        # dC0 = q^T (dnum), (dh, Q) x (Q, dh) per row and head of the
        # first chunk (Q = min(128, S): mlstm_scan's chunk)
        heads = cfg.n_heads // model
        dh = cfg.d_inner_mlstm // cfg.n_heads
        n += (_count(cfg, mixer="mlstm") * 2 * rows * heads * min(128, S)
              * dh * dh)
    if any(layer.mixer == "slstm" for layer in cfg.pattern):
        # dh0 = drec r^T, (1, 4 dh) x (4 dh, dh) per row and head of the
        # first step
        heads = cfg.n_heads // model
        dh = cfg.d_model // cfg.n_heads
        n += _count(cfg, mixer="slstm") * 2 * rows * heads * 4 * dh * dh
    return n


def terms(arch: str, kind: str) -> int:
    from repro_torch.configs import get_config, reduce_for_smoke
    if kind != "train":
        return 0
    cfg = reduce_for_smoke(get_config(arch))
    return (recomputes(cfg) + outer_products(cfg)
            - initial_state_grads(cfg))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_per_device_match_the_reference(ref_cells, port_run, arch,
                                              kind):
    want, got = ref_cells[f"{arch}:{kind}"], \
        port_run["cells"][f"{arch}:{kind}"]
    assert want["status"] == got["status"] == "OK", (want, got)
    ref_flops = want["hlo_analysis"]["flops_per_device"]
    port_flops = got["hlo_analysis"]["flops_per_device"]
    extra = terms(arch, kind)
    assert ref_flops > 0
    assert port_flops == ref_flops + extra, (port_flops, ref_flops, extra,
                                             port_flops - ref_flops)
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got["n_chips"] == want["n_chips"] == 8


@pytest.mark.parametrize("arch", MOE)
def test_plan_splits_the_experts(port_run, arch):
    """At (2, 4) the 4 smoke experts split one a rank ("expert"), llama4's
    shared expert by its d_ff ("shared"), with the dense kinds."""
    from repro_torch.configs import get_config, reduce_for_smoke
    name = reduce_for_smoke(get_config(arch)).name
    assert set(port_run["kinds"][name]) == PLANS[arch]


def test_port_loads_neither_jax_nor_repro(port_run):
    assert port_run["loaded"] == []
