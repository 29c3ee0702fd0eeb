"""The port's roofline analyzer against the reference's, exactly.

``repro_torch.analysis.roofline`` is a copy of ``repro.analysis.roofline``
(imports rewritten, ``CHIPS_PER_HOST`` and the rates bound to the H100
and a DGX H100 host): both run the same Python arithmetic on the same
text, so every field must be equal, not close.  Inputs: the synthetic
HLO of ``tests/test_roofline.py`` and HLO text compiled here by XLA on
the CPU (a scanned matmul, nested scans, a batched dot, an elementwise
chain, and an all-reduce over a mesh of 4 forced devices, in a
subprocess).  ``roofline_terms`` is held with the reference's rates
monkeypatched to the port's, the reference's files untouched.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import roofline as ref
from repro_torch.analysis import roofline as port
from repro_torch.core import netem

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

SYNTHETIC = {
    "pod-classification": """
HloModule m

ENTRY %main (p: f32[256,16]) -> f32[256,16] {
  %p = f32[256,16] parameter(0)
  %ar0 = f32[256,16] all-reduce(%p), replica_groups=[32,16]<=[512]
  ROOT %ar1 = f32[256,16] all-reduce(%ar0), replica_groups=[256,2]<=[2,256]T(1,0)
}
""",
    "collectives-and-slices": """
HloModule m2

%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,16] get-tuple-element(%p), index=1
  %w = f32[16,16] constant({...})
  %d = f32[8,16] dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ag = f32[32,16] all-gather(%d), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[8,16] reduce-scatter(%ag), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[8,16] collective-permute(%rs), source_target_pairs={{0,1},{1,0}}
  %a2a = f32[8,16] all-to-all(%cp), replica_groups={{0,256}}
  ROOT %t = (s32[], f32[8,16]) tuple(%i, %a2a)
}

%cond (p: (s32[], f32[8,16])) -> pred[] {
  %p = (s32[], f32[8,16]) parameter(0)
  ROOT %c = pred[] constant(true)
}

ENTRY %main (x: f32[8,16]) -> (s32[], f32[8,16]) {
  %x = f32[8,16] parameter(0)
  %z = s32[] constant(0)
  %t = (s32[], f32[8,16]) tuple(%z, %x)
  %ds = f32[4,16] dynamic-slice(%x, %z, %z), dynamic_slice_sizes={4,16}
  ROOT %w = (s32[], f32[8,16]) while(%t), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"7"}}
}
""",
}


def _compiled(fn, *specs) -> str:
    return jax.jit(fn).lower(*specs).compile().as_text()


def _scan_matmul():
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=10)[0]
    return _compiled(f, jax.ShapeDtypeStruct((128, 256), jnp.float32),
                     jax.ShapeDtypeStruct((256, 256), jnp.float32))


def _nested_scan():
    def f(x):
        def outer(c, _):
            def inner(d, _):
                return d @ d, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]
    return _compiled(f, jax.ShapeDtypeStruct((64, 64), jnp.float32))


def _batched_dot():
    return _compiled(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                     jax.ShapeDtypeStruct((4, 32, 64), jnp.float32),
                     jax.ShapeDtypeStruct((4, 64, 16), jnp.bfloat16))


def _elementwise():
    def f(x):
        for _ in range(10):
            x = jnp.tanh(x) * 1.5 + 0.5
        return x
    return _compiled(f, jax.ShapeDtypeStruct((1024, 1024), jnp.float32))


SHARDED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
x = jax.ShapeDtypeStruct((64, 128), jnp.float32,
                         sharding=NamedSharding(mesh, P("data", "model")))
w = jax.ShapeDtypeStruct((128, 32), jnp.float32,
                         sharding=NamedSharding(mesh, P("model", None)))
f = jax.jit(lambda x, w: jnp.sum(x @ w, axis=0),
            out_shardings=NamedSharding(mesh, P()))
print(json.dumps(f.lower(x, w).compile().as_text()))
"""


@pytest.fixture(scope="module")
def hlo_texts():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", SHARDED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    texts = dict(SYNTHETIC)
    texts.update({"scan-matmul": _scan_matmul(),
                  "nested-scan": _nested_scan(),
                  "batched-dot": _batched_dot(),
                  "elementwise": _elementwise(),
                  "sharded-all-reduce": json.loads(
                      out.stdout.strip().splitlines()[-1])})
    assert "all-reduce" in texts["sharded-all-reduce"]
    return texts


NAMES = list(SYNTHETIC) + ["scan-matmul", "nested-scan", "batched-dot",
                           "elementwise", "sharded-all-reduce"]


def _entry(text: str) -> str:
    import re
    m = re.search(r"^ENTRY\s+%?([\w\.\-]+)", text, re.M)
    return m.group(1) if m else "main"


@pytest.mark.parametrize("name", NAMES)
def test_parse_hlo_equals_reference(hlo_texts, name):
    got, want = port.parse_hlo(hlo_texts[name]), ref.parse_hlo(
        hlo_texts[name])
    assert list(got) == list(want)
    for cname, comp in want.items():
        assert dataclasses.asdict(got[cname]) == dataclasses.asdict(comp)


@pytest.mark.parametrize("name", NAMES)
def test_computation_multipliers_equal_reference(hlo_texts, name):
    text = hlo_texts[name]
    got = port.computation_multipliers(port.parse_hlo(text), _entry(text))
    want = ref.computation_multipliers(ref.parse_hlo(text), _entry(text))
    assert got == want
    assert max(want.values()) >= 1


@pytest.mark.parametrize("chips_per_pod", [2, 256])
@pytest.mark.parametrize("name", NAMES)
def test_analyze_hlo_equals_reference(hlo_texts, name, chips_per_pod):
    got = port.analyze_hlo(hlo_texts[name], chips_per_pod=chips_per_pod)
    want = ref.analyze_hlo(hlo_texts[name], chips_per_pod=chips_per_pod)
    assert got.to_json() == want.to_json()
    if name != "elementwise":
        assert want.flops > 0 or want.collectives


GROUPS = ["replica_groups={{0,1},{2,3}}", "replica_groups=[2,2]<=[4]",
          "replica_groups=[2,2]<=[2,2]T(1,0)",
          "replica_groups=[32,16]<=[512]",
          "replica_groups=[256,2]<=[2,256]T(1,0)",
          "replica_groups={{0,1,2},{3,4}}", "channel_id=1"]


@pytest.mark.parametrize("attrs", GROUPS)
def test_parse_groups_equals_reference(attrs):
    got, want = port._parse_groups(attrs), ref._parse_groups(attrs)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_rates_are_the_cards():
    """The port's rates are the H100 SXM5's and a DGX H100 host's; none
    is the reference's."""
    assert (netem.PEAK_FLOPS_BF16, netem.HBM_BW, netem.ICI_BW,
            netem.DCN_BW, port.CHIPS_PER_HOST) == (989e12, 3.35e12, 450e9,
                                                   400e9, 8)
    from repro.core import netem as jnetem
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "DCN_BW"):
        assert getattr(netem, name) != getattr(jnetem, name), name
    assert netem.collective_time_s(450e9, 400e9) == 2.0


@pytest.mark.parametrize("name", NAMES)
def test_roofline_terms_equal_reference_at_the_ports_rates(
        hlo_texts, name, monkeypatch):
    for k in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "DCN_BW",
              "CHIPS_PER_HOST"):
        monkeypatch.setattr(ref, k, getattr(port, k))
    a = ref.analyze_hlo(hlo_texts[name], chips_per_pod=2)
    b = port.analyze_hlo(hlo_texts[name], chips_per_pod=2)
    for model_flops, n in ((a.flops * 4 + 1.0, 4), (0.0, 1)):
        want = ref.roofline_terms(a, model_flops_total=model_flops,
                                  n_chips=n)
        got = port.roofline_terms(b, model_flops_total=model_flops,
                                  n_chips=n)
        assert got.to_json() == want.to_json()


def test_roofline_terms_bottlenecks_at_the_ports_rates():
    """Each term alone is the bottleneck, priced at the card's rates."""
    for field, rate, term in (("flops", netem.PEAK_FLOPS_BF16, "compute"),
                              ("hbm_bytes", netem.HBM_BW, "memory"),
                              ("ici_bytes", netem.ICI_BW, "ici"),
                              ("dcn_bytes", netem.DCN_BW / 8, "dcn")):
        a = port.HLOAnalysis(**{field: rate})
        r = port.roofline_terms(a, model_flops_total=0.0, n_chips=1)
        assert r.bottleneck == term
        assert getattr(r, f"t_{term}") == 1.0
