"""The serving bundles' specs and rules against the reference, in one
process.

- ``train_input_specs`` and ``serve_input_specs`` give meta tensors of the
  reference's shapes and dtypes for every config at ``prefill_32k`` and
  ``decode_32k``; the port's decode cache is one dict per group, the
  reference's stacks the groups on a leading dim;
- ``decode_cache_rules`` equals the reference's for every config on a
  ``("data", "model")`` mesh with ``model`` of 1, 2, 4, 8 and 16.

All comparisons are exact.  The bundles on meshes are held against the
reference in ``tests/test_torch_serve_bundles.py``.
"""
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES, get_config as jget
from repro.train import steps as jsteps
from repro_torch.configs import _REGISTRY, SHAPES, get_config
from repro_torch.train import steps

ARCHS = sorted(_REGISTRY)
SERVE_SHAPES = ("prefill_32k", "decode_32k")
MODEL_SIZES = (1, 2, 4, 8, 16)


class FakeMesh:
    """The reference's mesh stand-in (``tests/test_sharding.py``)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


def _sd(x) -> tuple:
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _all_meta(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_meta(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_all_meta(v) for v in tree)
    return tree.device.type == "meta"


@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    got = steps.train_input_specs(cfg, SHAPES[shape])
    want = jsteps.train_input_specs(jcfg, JSHAPES[shape])
    assert {k: _sd(v) for k, v in got.items()} == \
        {k: _sd(v) for k, v in want.items()}
    got = steps.serve_input_specs(cfg, SHAPES[shape])
    want = jsteps.serve_input_specs(jcfg, JSHAPES[shape])
    assert _all_meta(got)
    for key in ("tokens", "pos"):
        assert _sd(got[key]) == _sd(want[key]), key
    assert len(got["cache"]) == cfg.n_groups
    n = 0
    for gc in got["cache"]:
        assert set(gc) == set(want["cache"])
        for layer, tree in gc.items():
            assert set(tree["mixer"]) == set(want["cache"][layer]["mixer"])
            for name, leaf in tree["mixer"].items():
                ref_shape, ref_dtype = _sd(want["cache"][layer]["mixer"][
                    name])
                assert ref_shape[0] == cfg.n_groups
                assert _sd(leaf) == (ref_shape[1:], ref_dtype), (layer, name)
                n += 1
    assert n


@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_rules_match_reference(arch, m):
    sizes = {"data": 16, "model": m}
    got = steps.decode_cache_rules(get_config(arch),
                                   (tuple(sizes), tuple(sizes.values())))
    assert got == jsteps.decode_cache_rules(jget(arch), FakeMesh(sizes))
