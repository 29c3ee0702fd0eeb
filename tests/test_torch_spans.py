"""The port's spans and counters (``repro_torch.obs.spans``,
``repro_torch.models.moe.pair_counts``) on the CPU, at smoke size.

- Without a profiler no span opens a range or puts an autograd function
  in the graph, and the counters stay at zero.
- Under a CPU profiler every span of the train step appears nested under
  ``train.step``; the MoE dispatch's and combine's backward ranges hold
  the indexing backward ops; ``attn.flash_bwd`` holds the attention
  backward's recompute inside ``repro_torch::flash_attention_bwd``; the
  serving bundles' entries and layers appear, on the mesh-free and
  (in a subprocess, one gloo rank) the mesh routes.
- Loss, gradients and updated parameters are bit for bit the same with
  the profiler on and off.
- The counters equal ``keep.numel()`` and ``(~keep).sum()`` of every
  ``route`` call.
"""
import ast
import contextlib
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.obs import spans
from repro_torch.train import make_step_bundle

SRC = Path(__file__).resolve().parent.parent / "src"
B, S = 2, 16
# the spans of a mesh-free MoE train step on the CPU (the CPU path takes
# no attention kernel, so no ``attn.flash_bwd``; no serving entry)
TRAIN_SPANS = set(spans.NAMES) - {"attn.flash_bwd", "serve.decode_step"}


def _cfg(capacity: float = 1.25, remat: str = "full"):
    """granite-moe at smoke size; a capacity under 1 drops pairs."""
    cfg = reduce_for_smoke(get_config("granite-moe-3b-a800m"), d_model=64,
                           vocab=128)
    return dataclasses.replace(
        cfg, remat=remat,
        moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


def _batch(cfg, i: int = 0) -> dict:
    g = torch.Generator().manual_seed(100 + i)
    return {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
            for k in ("inputs", "labels")}


def _state(bundle):
    return bundle.init_fn(torch.Generator().manual_seed(0))


def _ranges(prof) -> list:
    """(start ns, end ns, name) of each of the port's ranges."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in spans.NAMES)


def _events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_every_span_name_is_listed():
    """Every name the port passes to ``span``/``spanned`` (and its
    ``.backward``) is in ``NAMES``, and every listed name is used."""
    used = set()
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        if "obs.spans import" not in text and "obs import spans" not in text:
            continue
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Call) and ast.unparse(node.func) in (
                    "span", "spanned", "spans.span", "spans.spanned"):
                name = node.args[0].value
                used.add(name)
                if any(k.arg == "backward" for k in node.keywords):
                    used.add(name + ".backward")
    assert used == set(spans.NAMES)


def test_off_costs_one_flag_test():
    assert not spans.on()
    s = spans.span("train.step", backward=True)
    t = torch.ones(3, requires_grad=True)
    assert s is spans.span("moe.dispatch") and s.input(t) is t
    assert s.output(t) is t


def test_off_the_step_has_no_span_node_and_no_range(monkeypatch):
    cfg = _cfg(capacity=0.5)
    bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    state = _state(bundle)
    opened = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: opened.append(name))
    moe.reset_pair_counts()
    loss, _ = state["params"].loss(_batch(cfg))
    seen, todo, names = set(), [loss.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    assert len(seen) > 50
    assert not {n for n in names if "_Open" in n or "_Close" in n}, names
    bundle.step_fn(state, _batch(cfg, 1))
    assert opened == []
    assert moe.pair_counts() == {"moe.pairs_routed": 0,
                                 "moe.pairs_dropped": 0}


def test_train_step_spans_nest_under_the_step():
    cfg = _cfg()
    bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    state = _state(bundle)
    bundle.step_fn(state, _batch(cfg, 0))
    with _cpu_profile() as prof:
        bundle.step_fn(state, _batch(cfg, 1))
    rs = _ranges(prof)
    steps = [r for r in rs if r[2] == "train.step"]
    assert len(steps) == 1
    t0, t1, _ = steps[0]
    assert {r[2] for r in rs} == TRAIN_SPANS
    assert all(t0 <= s and e <= t1 for s, e, _ in rs)
    count = Counter(r[2] for r in rs)
    layers = cfg.n_layers
    # forward and remat recompute; one backward range a layer
    for name in ("layer.mixer", "layer.ffn", "moe.route", "moe.dispatch",
                 "moe.experts", "moe.combine"):
        assert count[name] == 2 * layers, (name, count)
    for name in ("moe.dispatch.backward", "moe.combine.backward"):
        assert count[name] == layers, (name, count)
    assert count["optim.adamw"] == 1

    def inside(op_names, span_name):
        ranges = [r for r in rs if r[2] == span_name]
        return sum(1 for e in _events(prof) if e.name() in op_names and any(
            s <= e.start_ns() and e.end_ns() <= t for s, t, _ in ranges))

    for name in ("moe.dispatch.backward", "moe.combine.backward"):
        assert inside({"IndexBackward0"}, name) == layers, name
        assert inside({"aten::_index_put_impl_"}, name) >= layers, name


def test_flash_attention_backward_span_on_the_cpu():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=g, requires_grad=True)
               for _ in range(3))
    with _cpu_profile() as prof:
        ops.flash_attention(q, k, v, 0.25).sum().backward()
    events = _events(prof)
    bwd = [e for e in events if e.name() == "attn.flash_bwd"]
    op = [e for e in events if e.name() == "repro_torch::flash_attention_bwd"]
    assert len(bwd) == 1 and len(op) == 1
    s, t = bwd[0].start_ns(), bwd[0].end_ns()
    assert op[0].start_ns() <= s and t <= op[0].end_ns()
    inner = [e.name() for e in events
             if s < e.start_ns() and e.end_ns() <= t]
    assert "aten::softmax" in inner or "aten::_softmax" in inner, inner
    assert sum(n.endswith("Backward0") for n in inner) >= 3, inner


def _grads_and_step(cfg, profiled: bool):
    """The loss and gradients of batch 0, then a train step on batch 1:
    (loss, gradients, parameters and first moments after the step)."""
    bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    state = _state(bundle)
    model = state["params"]
    params = dict(model.named_parameters())
    with _cpu_profile() if profiled else contextlib.nullcontext():
        loss, _ = model.loss(_batch(cfg))
        grads = torch.autograd.grad(loss, list(params.values()))
        bundle.step_fn(state, _batch(cfg, 1))
    return (loss.detach(), grads,
            {k: p.detach().clone() for k, p in params.items()},
            {k: t.clone() for k, t in state["opt"]["m"].items()})


@pytest.mark.parametrize("remat", ["full", "none"])
def test_profiler_on_and_off_bit_for_bit(remat):
    cfg = _cfg(capacity=0.5, remat=remat)
    off = _grads_and_step(cfg, False)
    on = _grads_and_step(cfg, True)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    for i in (2, 3):
        assert off[i].keys() == on[i].keys()
        assert all(torch.equal(off[i][k], on[i][k]) for k in off[i])


@pytest.mark.parametrize("remat", ["full", "none"])
def test_pair_counters_equal_route(monkeypatch, remat):
    # at 0.75 the capacity keeps other than half the pairs
    cfg = _cfg(capacity=0.75, remat=remat)
    bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    state = _state(bundle)
    keeps = []
    route = moe.route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        keeps.append(out[-1].clone())
        return out

    monkeypatch.setattr(moe, "route", recording)
    moe.reset_pair_counts()
    with _cpu_profile():
        bundle.step_fn(state, _batch(cfg))
    calls = cfg.n_layers * (2 if remat == "full" else 1)
    assert len(keeps) == calls
    got = moe.pair_counts()
    assert got["moe.pairs_routed"] == sum(k.numel() for k in keeps)
    assert got["moe.pairs_dropped"] == sum(int((~k).sum()) for k in keeps)
    assert 0 < got["moe.pairs_dropped"] < got["moe.pairs_routed"] / 2
    moe.reset_pair_counts()
    assert moe.pair_counts() == {"moe.pairs_routed": 0,
                                 "moe.pairs_dropped": 0}


def test_backward_span_waits_for_every_marked_input():
    """The region's backward range closes once the last marked input's
    gradient has left; an input that needs no gradient is not marked."""
    x = torch.randn(6, 3, requires_grad=True)
    y0 = torch.randn(3, requires_grad=True)
    w = torch.randn(3)
    with _cpu_profile() as prof:
        with spans.span("moe.dispatch", backward=True) as s:
            assert s.input(w) is w
            y = s.output(s.input(x)[torch.tensor([0, 2, 2])] * s.input(y0)
                         * w)
        (y * 2).sum().backward()
    rs = [r for r in _ranges(prof) if r[2] == "moe.dispatch.backward"]
    assert len(rs) == 1
    start, end, _ = rs[0]
    inside = Counter(e.name() for e in _events(prof)
                     if start <= e.start_ns() <= end)
    assert inside["IndexBackward0"] == 1 and inside["_CloseBackward"] == 2


def test_serving_bundles_spans():
    cfg = _cfg()
    pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"))
    db = make_step_bundle(cfg, ShapeCfg("d", S + 4, B, "decode"))
    model = _state(make_step_bundle(cfg, ShapeCfg("t", S, B, "train")))[
        "params"]
    model.requires_grad_(False)
    toks = _batch(cfg)["inputs"]
    with _cpu_profile() as prof:
        logits, cache = pb.step_fn(model, toks)
    names = Counter(r[2] for r in _ranges(prof))
    assert names["model.embed"] == names["model.logits"] == 1
    assert names["layer.mixer"] == names["moe.dispatch"] == cfg.n_layers
    big = model.init_cache(B, S + 4, torch.float32)
    with _cpu_profile() as prof:
        db.step_fn(model, big, logits.argmax(-1), S)
    rs = _ranges(prof)
    step = [r for r in rs if r[2] == "serve.decode_step"]
    assert len(step) == 1
    assert {r[2] for r in rs} == {"serve.decode_step", "model.embed",
                                  "layer.mixer", "layer.ffn", "moe.route",
                                  "moe.dispatch", "moe.experts",
                                  "moe.combine", "model.logits"}
    assert all(step[0][0] <= s and e <= step[0][1] for s, e, _ in rs)


MESH = """
import sys, tempfile, dataclasses, torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.spans import NAMES
from repro_torch.train import make_step_bundle
from repro_torch.train.steps import place_params, full_state
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
cfg = dataclasses.replace(reduce_for_smoke(get_config(
    "granite-moe-3b-a800m"), d_model=64, vocab=128), remat="full")
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
B, S = 2, 16
tb = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"), mesh)
state = tb.init_fn(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
         for k in ("inputs", "labels")}
pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"), mesh)
db = make_step_bundle(cfg, ShapeCfg("d", S, B, "decode"), mesh)
with profile(activities=[ProfilerActivity.CPU]) as prof:
    tb.step_fn(state, batch)
    params = place_params(cfg, full_state(state)["params"],
                          pb.in_shardings[0])
    logits, cache = pb.step_fn(params, batch["inputs"])
    db.step_fn(params, cache, batch["inputs"][:, :1], S - 1)
names = sorted({e.name() for e in prof.profiler.kineto_results.events()
                if e.name() in NAMES})
print("NAMES", " ".join(names))
dist.destroy_process_group()
"""


def test_mesh_bundles_spans(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", MESH,
                          str(tmp_path / "store")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("NAMES ")]
    assert set(line[0].split()[1:]) == TRAIN_SPANS | {"serve.decode_step"}
