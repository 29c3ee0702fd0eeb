"""Logical axes and sharding rules of the port against the reference.

- ``resolve_spec``, ``logical_rules`` and ``batch_spec`` equal the
  reference's on a mesh stand-in (the port's ``(names, shape)``, the
  reference's object with ``axis_names`` and ``devices.shape``), over
  hypothesis dims as in ``tests/test_sharding.py``;
- every config's ``param_axes()`` and ``cache_axes()`` equal the
  reference's leaf by leaf, a port leaf's axes being the reference's
  stacked axes without the leading "layers";
- every config's resolved parameter specs equal the reference's on
  (16, 16), (2, 16, 16), (2, 2) and (4, 2) meshes, plain and under
  ``fsdp_params``, int8 compression and ``seq_shard``;
- DTensor placements and local chunks of a spec, ``param_shapes()``
  allocating nothing, and ``make_production_mesh`` under the ``fake``
  process-group backend (a subprocess, so no group outlives the test).
All comparisons are exact.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st
from jax.sharding import PartitionSpec

from repro.configs import get_config as jget
from repro.distributed import sharding as jsh
from repro.models import Model as JModel
from repro_torch.configs import _REGISTRY, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.models import Model

ARCHS = sorted(_REGISTRY)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}}
OPTIONS = {"plain": {}, "fsdp": dict(fsdp_params=True),
           "fsdp_int8": dict(fsdp_params=True, grad_compression="int8"),
           "seq": dict(seq_shard=True)}


class FakeMesh:
    """The reference's stand-in (``tests/test_sharding.py``)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


def both(sizes: dict):
    return FakeMesh(sizes), (tuple(sizes), tuple(sizes.values()))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def unrolled(cfg, tree, is_leaf, value) -> dict:
    """The reference's tree as {port key: value(leaf, stacked)}: its groups
    are stacked (a dict: every group's leaf is the stacked one) or a list
    of group trees."""
    def walk(t, prefix, stacked):
        if is_leaf(t):
            return {prefix[:-1]: value(t, stacked)}
        out = {}
        for k, v in t.items():
            if prefix == "" and k == "groups":
                for i in range(cfg.n_groups):
                    out.update(walk(v[i] if isinstance(v, list) else v,
                                    f"groups.{i}.", not isinstance(v, list)))
            else:
                out.update(walk(v, f"{prefix}{k}.", stacked))
        return out
    return walk(tree, "", False)


def _strip(tree):
    """A stacked axes tree without its leading "layers"."""
    if _is_axes(tree):
        assert tree[0] == "layers", tree
        return tree[1:]
    return {k: _strip(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@given(dim0=st.integers(1, 512), dim1=st.integers(1, 512),
       data=st.sampled_from([1, 2, 4, 8, 16]),
       model=st.sampled_from([1, 2, 4, 8, 16]),
       pod=st.sampled_from([0, 2]))
@settings(max_examples=100, deadline=None)
def test_resolve_spec_equals_reference(dim0, dim1, data, model, pod):
    sizes = {"pod": pod} if pod else {}
    sizes.update(data=data, model=model)
    jm, tm = both(sizes)
    rules = {"embed": ("pod", "data"), "ffn": ("model",),
             "heads": ("model",), "batch": ("pod", "data"), "none": ()}
    for axes in (("embed", "ffn"), ("ffn", "heads"), ("batch", None),
                 ("none", "embed"), (None, "batch")):
        want = jsh.resolve_spec(axes, (dim0, dim1), rules, jm)
        got = tsh.resolve_spec(axes, (dim0, dim1), rules, tm)
        assert tuple(got) == tuple(want), (axes, got, want)


@given(batch=st.integers(1, 512), extra=st.sampled_from([0, 1, 2]),
       data=st.sampled_from([1, 2, 3, 16]), pod=st.sampled_from([0, 2]))
@settings(max_examples=100, deadline=None)
def test_batch_spec_equals_reference(batch, extra, data, pod):
    sizes = {"pod": pod} if pod else {}
    sizes.update(data=data, model=4)
    jm, tm = both(sizes)
    for bs in (None, batch):
        assert tuple(tsh.batch_spec(tm, extra, bs)) == \
            tuple(jsh.batch_spec(jm, extra, bs))


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_rules_equal_reference(mesh, option):
    for arch in ("qwen2-7b", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(get_config(arch), **OPTIONS[option])
        jcfg = dataclasses.replace(jget(arch), **OPTIONS[option])
        jm, tm = both(MESHES[mesh])
        assert tsh.logical_rules(cfg, tm) == jsh.logical_rules(jcfg, jm)


# ---------------------------------------------------------------------------
# every config's axes and specs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_trees():
    """{arch: (param axes, param shapes, cache axes)} of the reference."""
    out = {}
    for arch in ARCHS:
        m = JModel(jget(arch))
        shapes, axes = m.param_shapes()
        out[arch] = (axes, shapes, m.cache_axes())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_equal_reference(reference_trees, arch):
    cfg = get_config(arch)
    jaxes, jshapes, jcache = reference_trees[arch]
    model = Model(cfg, device="meta")
    assert model.param_axes() == unrolled(
        cfg, jaxes, _is_axes, lambda a, stacked: _strip(a) if stacked else a)
    want_cache = (jcache if isinstance(jcache, list)
                  else [_strip(jcache)] * cfg.n_groups)
    assert model.cache_axes() == want_cache
    # and the shapes behind the axes
    shapes, axes = model.param_shapes()
    assert axes == model.param_axes()
    assert {k: tuple(t.shape) for k, t in shapes.items()} == unrolled(
        cfg, jshapes, lambda t: hasattr(t, "shape"),
        lambda t, stacked: tuple(t.shape[1:] if stacked else t.shape))


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolved_param_specs_equal_reference(reference_trees, mesh,
                                              option):
    jm, tm = both(MESHES[mesh])
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), **OPTIONS[option])
        jcfg = dataclasses.replace(jget(arch), **OPTIONS[option])
        jaxes, jshapes, _ = reference_trees[arch]
        want = jsh.resolve_axes_tree(jaxes, jshapes, jcfg, jm)
        shapes, axes = Model(cfg, device="meta").param_shapes()
        got = tsh.resolve_axes_tree(axes, shapes, cfg, tm)
        flat_want = unrolled(
            cfg, want, lambda t: isinstance(t, PartitionSpec),
            # a stacked leaf's spec leads with None ("layers" -> ())
            lambda p, stacked: tuple(p)[1:] if stacked else tuple(p))
        assert {k: tuple(p) for k, p in got.items()} == flat_want, arch


# ---------------------------------------------------------------------------
# placements, shapes, the production mesh
# ---------------------------------------------------------------------------


class _Mesh:
    """A DeviceMesh stand-in for ``local_chunk``: shape and coordinate."""

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, coord

    def get_coordinate(self):
        return self._coord


def test_placements_and_chunks_follow_jax_device_order():
    """P(("pod", "data"), "model") on (2, 2, 2): dim 0 in 4 chunks, pod
    the slower, as JAX lays out its shards."""
    from torch.distributed.tensor import Replicate, Shard
    names = (("pod", "data", "model"), (2, 2, 2))
    spec = tsh.P(("pod", "data"), "model")
    assert tsh.to_placements(spec, names) == [Shard(0), Shard(0), Shard(1)]
    assert tsh.to_placements(tsh.P(None, "data"), names) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        tsh.to_placements(tsh.P(("data", "pod")), names)
    full = torch.arange(8 * 4).reshape(8, 4)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                got = tsh.local_chunk(full, _Mesh((2, 2, 2), (p, d, m)),
                                      tsh.to_placements(spec, names))
                i = p * 2 + d
                assert torch.equal(got, full[2 * i:2 * i + 2,
                                             2 * m:2 * m + 2])


def test_act_constrain_is_a_noop_on_local_tensors():
    cfg = get_config("qwen2-7b")
    x = torch.ones(4, 8)
    assert tsh.act_constrain(x, ("act_batch", None)) is x
    with tsh.activation_sharding((("data", "model"), (2, 2)), cfg):
        assert tsh.current_mesh() == (("data", "model"), (2, 2))
        assert tsh.act_constrain(x, ("act_batch", None)) is x
    with tsh.activation_sharding((("pod", "data"), (2, 2)), cfg,
                                 exclude=("pod",)):
        assert tsh.current_rules()["act_batch"] == ("data",)
    assert tsh.current_mesh() is None
    assert tsh.constrain(x, tsh.P("data")) is x


def test_param_shapes_allocate_nothing():
    model = Model(get_config("llama4-maverick-400b-a17b"), device="meta")
    shapes, axes = model.param_shapes()
    assert all(t.device.type == "meta" for t in shapes.values())
    assert set(shapes) == set(axes)
    n = sum(math.prod(t.shape) for t in shapes.values())
    assert n > 3e11          # the full 400B tree, never allocated


PRODUCTION = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
for multi, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi, device_type="cpu")
    print(mesh_axis_sizes(m), m.get_coordinate())
    dist.destroy_process_group()
"""


def test_make_production_mesh_under_fake_backend():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", PRODUCTION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines == ["{'data': 16, 'model': 16} (0, 3)",
                     "{'pod': 2, 'data': 16, 'model': 16} (0, 0, 3)"]
