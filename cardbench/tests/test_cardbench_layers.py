"""Layer kinds (``layers/<kind>.py``, ``benchlib.kinds``): the three
cells read what they read before the kinds were split out (pins frozen
from the harness as it was), a period of two kinds is laid out, counted,
checked against the port and run, and a kind added as a file is found by
name."""
import dataclasses
import hashlib
import json
import shutil
import time
from functools import partial
from types import SimpleNamespace

import pytest
import torch

import smoke
from benchlib import harness, kinds, port, weights, work
from benchlib.loops import loop_for
from benchlib.loops.prefill import lengths
from reference import plain

TRAIN, PREFILL, DECODE = ("granite-moe-3b.train-4x1024",
                          "qwen2-7b.prefill-8k-32k", "qwen2-7b.decode-24x32k")
SEED = 2 ** 31 + 77


def digest(x) -> str:
    return hashlib.sha256(json.dumps(x).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Pins: the harness's readings of the three cells before the layer kinds
# ---------------------------------------------------------------------------

# sha256 of [[name, shape, mean, std], ...], the first 16 hex digits
LEAVES = {"granite-moe-3b-a800m": "d23b587d410948a1",
          "qwen2-7b": "0db2be88aba534f0"}
N_PARAMS = {"granite-moe-3b-a800m": 3374295552, "qwen2-7b": 7615616512}
TRAIN_STEP = (22933225340928, 94480275456)
PREFILL_WORK = {
    8192: (120382077534208, 14669720576), 9280: (138396613476352, 14739909632),
    10560: (160198527025152, 14822484992),
    11968: (184940237160448, 14913317888),
    13568: (214021765070848, 15016537088),
    15360: (247813048369152, 15132142592),
    17472: (289293343653888, 15268391936),
    19776: (336586630496256, 15417027584),
    22464: (394455277633536, 15590435840),
    25472: (462651825061888, 15784487936),
    28864: (543911357710336, 16003312640),
    32768: (643153249435648, 16255167488)}
# decode_step at each of the 128 positions: the first, the last, a digest
DECODE_WORK = ((653830324224, 59063782400), (655053815808, 59238566912),
               "4626d17bbcc24607")
PER_UNIT = {TRAIN: {"flash_attention": 64}, PREFILL: {"flash_attention": 28},
            DECODE: {"flash_decode": 28}}
# seed_of(SEED, 2, layer, 0 | 1) for layers 0-31; a (2, 8)-position
# history of layers 0 and 5 (k, v) drawn on the CPU
STREAMS = "aac5214ca04959fd"
HISTORY = "3a26aed079e53567"


@pytest.mark.parametrize("config", sorted(LEAVES))
def test_leaves_and_parameters_are_pinned(bench, config):
    c = bench.config_file(config)
    assert digest([[s.name, list(s.shape), s.mean, s.std]
                   for s in weights.leaf_specs(c)]) == LEAVES[config]
    assert work.n_params(c) == N_PARAMS[config]


def test_work_at_the_cells_shapes_is_pinned(bench):
    g = bench.config_file("granite-moe-3b-a800m")
    q = bench.config_file("qwen2-7b")
    assert work.train_step(g, 4, 1024) == TRAIN_STEP
    ls = lengths(bench.cell(PREFILL).traffic["lengths"])
    assert {S: work.prefill(q, S) for S in ls} == PREFILL_WORK
    t = bench.cell(DECODE).traffic
    steps = [work.decode_step(q, t["batch"], pos) for pos in
             range(t["history"], t["history"] + t["new_tokens"])]
    assert (steps[0], steps[-1], digest(steps)) == DECODE_WORK


@pytest.mark.parametrize("cell", sorted(PER_UNIT))
def test_launches_a_unit_are_pinned(bench, cell):
    run = harness.make_run(bench, cell, 1, "cpu")
    assert loop_for(run.traffic["kind"])(run).per_unit == PER_UNIT[cell]


@pytest.mark.parametrize("config", sorted(LEAVES))
def test_history_streams_are_pinned(bench, config):
    c = bench.config_file(config)
    assert digest([weights.seed_of(SEED, 2, layer, k) for layer in range(32)
                   for k in (0, 1)]) == STREAMS
    attn = kinds.kind("attn")
    hist = [attn.history(c, SEED, layer, 2, 8, "cpu") for layer in (0, 5)]
    flat = torch.cat([h[k].float().flatten() for h in hist
                      for k in ("k", "v")])
    assert hashlib.sha256(flat.numpy().tobytes()).hexdigest()[:16] == HISTORY
    KV, hd = c["num_key_value_heads"], c["head_dim"]
    assert hist[0]["k"].shape == (2, KV, hd, 8)
    assert hist[0]["v"].shape == (2, KV, 8, hd)


# ---------------------------------------------------------------------------
# A period of two kinds: llama4's interleave, without its shared expert
# ---------------------------------------------------------------------------

PERIOD = [["attn", "moe"], ["attn", "mlp"]]


def two_kind_arch():
    """llama4-maverick's ArchConfig at a size the CPU holds: the period
    attn/moe, attn/mlp kept, float32, no shared expert.  The capacity is
    E / k, so no pair is dropped: a decode step routes its batch's rows
    and the reference the sampled rows' positions, and drops would
    differ between the two groupings."""
    from repro_torch.configs import get_config
    full = get_config("llama4-maverick-400b-a17b")
    D, H, F = 64, 4, 128
    moe = dataclasses.replace(full.moe, num_experts=4, top_k=2, d_ff=F,
                              capacity_factor=2.0, shared_expert=False)
    return dataclasses.replace(
        full, n_layers=4, d_model=D, n_heads=H, n_kv_heads=2,
        head_dim=D // H, d_ff=F, vocab_size=256, moe=moe,
        param_dtype="float32", compute_dtype="float32",
        opt_dtype="float32", cache_dtype="float32", fsdp_params=False,
        microbatches=1)


def two_kind_config(arch) -> dict:
    """The configuration file that states ``arch``."""
    return {
        "name": "two-kind", "layers": PERIOD,
        "hidden_size": arch.d_model, "num_hidden_layers": arch.n_layers,
        "num_attention_heads": arch.n_heads,
        "num_key_value_heads": arch.n_kv_heads, "head_dim": arch.head_dim,
        "intermediate_size": arch.d_ff, "vocab_size": arch.vocab_size,
        "num_local_experts": arch.moe.num_experts,
        "num_experts_per_tok": arch.moe.top_k,
        "capacity_factor": arch.moe.capacity_factor,
        "rope_theta": arch.rope_theta, "rms_norm_eps": arch.norm_eps,
        "attention_bias": arch.qkv_bias,
        "tie_word_embeddings": arch.tie_embeddings, "hidden_act": arch.act,
        "param_dtype": "float32", "compute_dtype": "float32",
        "opt_dtype": "float32", "cache_dtype": "float32",
        "remat": arch.remat}


def two_kind_layer(w, l, x, pos, c, lp, past=None):
    """The plain reference's layer of the period: attention, then routed
    experts at index 0 and a SwiGLU at index 1."""
    g, i = divmod(l, len(PERIOD))
    p = f"groups.{g}.l{i}."
    eps = c["rms_norm_eps"]
    h = plain.rmsnorm(x, w[p + "norm1.scale"].float(), eps)
    a, k, v = plain.attention_block(w, p + "mixer.", h, pos, c, lp, past)
    x = x + a
    h = plain.rmsnorm(x, w[p + "norm2.scale"].float(), eps)
    f = p + "ffn."
    if PERIOD[i][1] == "moe":
        out, aux = plain.moe(
            h.reshape(-1, h.shape[-1]), w[f + "router"].float(),
            w[f + "w_gate"].float(), w[f + "w_up"].float(),
            w[f + "w_down"].float(), c["num_experts_per_tok"],
            c["capacity_factor"], lp)
        return x + out.view_as(x), {"k": k, "v": v}, aux
    x = x + plain.in_rows(lambda t: plain.swiglu(
        t, w[f + "w_gate"].float(), w[f + "w_up"].float(),
        w[f + "w_down"].float(), lp), h)
    return x, {"k": k, "v": v}, 0.0


TWO_KIND_REFERENCE = SimpleNamespace(
    train_loss=partial(plain.train_loss, two_kind_layer),
    prefill=partial(plain.prefill, two_kind_layer),
    extend=partial(plain.extend, two_kind_layer))


def test_a_two_kind_period_is_the_ports_layout():
    from repro_torch.models import Model
    arch = two_kind_arch()
    c = two_kind_config(arch)
    assert port.arch_config(c, arch) is arch
    names = [layer.prefix for layer in kinds.layers(c)]
    assert names == ["groups.0.l0.", "groups.0.l1.", "groups.1.l0.",
                     "groups.1.l1."]
    meta = {k: tuple(p.shape) for k, p in
            Model(arch, device="meta").named_parameters()}
    specs = weights.leaf_specs(c)
    assert {s.name: s.shape for s in specs} == meta
    assert len(specs) == len(meta)
    assert work.n_params(c) == arch.n_params()
    assert "groups.1.l0.ffn.router" in meta and \
        "groups.1.l1.ffn.router" not in meta
    # the decode state the harness draws, bound as the port's cache
    states = [layer.mixer.history(c, SEED, layer.index, 3, 16, "cpu")
              for layer in kinds.layers(c)]
    cache = port.cache_from(arch, c, states, 16)
    want = Model(arch, device="meta").init_cache(3, 16, torch.float32)
    assert [{i: {k: (t.shape, t.dtype) for k, t in e["mixer"].items()}
             for i, e in g.items()} for g in cache] == \
        [{i: {k: (t.shape, t.dtype) for k, t in e["mixer"].items()}
          for i, e in g.items()} for g in want]
    assert port.layer_state(cache, kinds.layers(c)[3]) is states[3]
    # counted: launches a unit, and the work of both kinds
    assert kinds.launches(c, "decode") == {"flash_decode": 4}
    D, F, E, k = 64, 128, 4, 2
    H, KV, hd = 4, 2, 16
    attn = 2 * D * H * hd + 2 * D * KV * hd                 # q, o; k, v
    moe = D * E + k * 3 * D * F                             # router, k experts
    assert work._matrix(c) == 4 * attn + 2 * moe + 2 * 3 * D * F


@pytest.mark.parametrize("change,error", [
    ({"layers": [["attn", "mlp"], ["attn", "moe"]]}, "pattern"),
    ({"layers": [["attn", "moe"]]}, "pattern"),
    ({"num_hidden_layers": 3}, "whole number of periods"),
    ({"layers": [["attn", "attn"], ["attn", "mlp"]]}, "is a mixer"),
    ({"intermediate_size": 96}, "moe.d_ff"),
])
def test_a_wrong_period_raises(change, error):
    arch = two_kind_arch()
    c = dict(two_kind_config(arch), **change)
    with pytest.raises(ValueError, match=error):
        port.arch_config(c, arch)


def two_kind_run(bench, cell, seed, fault=None):
    """``cell``'s traffic at the smoke size over the two-kind period."""
    arch = two_kind_arch()
    run = harness.make_run(
        bench, cell, seed, "cpu", arch=arch, config=two_kind_config(arch),
        traffic=smoke.TRAFFIC[bench.cell(cell).traffic["kind"]],
        fault=fault)
    run.reference = TWO_KIND_REFERENCE
    return run


@pytest.mark.parametrize("cell", [TRAIN, PREFILL, DECODE])
def test_a_two_kind_period_runs_and_is_checked(bench, cell):
    run = two_kind_run(bench, cell, SEED)
    res = harness.run_cell(bench, run, 0.2, False, time.perf_counter(),
                           log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    if cell != TRAIN:
        assert res["checks"]["kv_err"]["value"] <= 1e-4
    bad = harness.run_cell(bench, two_kind_run(bench, cell, SEED,
                                               "unchanged"),
                           0.2, False, time.perf_counter(),
                           log=lambda *a, **k: None)
    assert not bad["correct"], bad["checks"]


@pytest.mark.parametrize("carried", [("k", "v"), ()])
def test_carried_state_is_put_back_each_request(bench, monkeypatch,
                                                carried):
    """A kind's ``CARRIED`` state is restored from the history before
    each request: with attention's K and V marked so, a history spoiled
    after set-up is put right; unmarked, it shows in the check."""
    monkeypatch.setattr(kinds.kind("attn"), "CARRIED", carried)
    from reference.plain import Float32
    run = smoke.smoke_run(bench, DECODE, SEED)
    loop = loop_for("decode")(run)
    loop.setup()
    for layer in loop.layers:
        port.layer_state(loop.cache, layer)["k"][..., :loop.hist] += 5.0
    loop.request(0)
    prog = loop.kept()
    loop.release()
    err = loop.compare(prog, loop.reference(Float32, prog))["kv_err"]
    assert (err <= 1e-4) == bool(carried), err


def test_a_kind_added_by_a_file_is_found_by_name(tmp_path, monkeypatch):
    layers = tmp_path / "layers"
    shutil.copytree(kinds.DIR, layers,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (layers / "probe_ffn.py").write_text(
        "from benchlib import weights\n"
        "ROLE = 'ffn'\n"
        "def leaves(c, p):\n"
        "    return [weights.norm(p + 'norm2.scale', c['hidden_size'])]\n"
        "def check(c, arch):\n"
        "    return {}\n"
        "def matrix(c):\n"
        "    return 0\n"
        "def params(c):\n"
        "    return c['hidden_size']\n"
        "def launches(unit):\n"
        "    return {'probe': 1}\n")
    monkeypatch.setattr(kinds, "DIR", layers)
    monkeypatch.delitem(__import__("sys").modules,
                        "cardbench_layer_probe_ffn", raising=False)
    c = dict(two_kind_config(two_kind_arch()),
             layers=[["attn", "probe_ffn"]], num_hidden_layers=2)
    assert kinds.kind("probe_ffn").ROLE == "ffn"
    names = [s.name for s in weights.leaf_specs(c)]
    assert "groups.1.l0.norm2.scale" in names
    assert not any(n.startswith("groups.0.l0.ffn.") for n in names)
    assert kinds.launches(c, "prefill") == {"flash_attention": 2,
                                            "probe": 2}
    with pytest.raises(FileNotFoundError,
                       match=r"cardbench/layers/mamba3\.py"):
        weights.leaf_specs(dict(c, layers=[["mamba3", "mlp"]]))


def test_a_nan_in_any_layers_state_is_not_hidden():
    """The largest error over the layers is NaN where one layer's is,
    whichever layer comes first (``max`` alone keeps a NaN only there)."""
    from benchlib import compare
    c = two_kind_config(two_kind_arch())
    layers = kinds.layers(c)
    ref = {layer.index: {"k": torch.ones(2, 3)} for layer in layers}
    prog = {i: {"k": t["k"].clone()} for i, t in ref.items()}
    assert compare.state_errs(layers, [(prog, ref)]) == {"kv_err": 0.0}
    prog[2]["k"][0, 0] = float("nan")
    err = compare.state_errs(layers, [(prog, ref)])["kv_err"]
    assert err != err
