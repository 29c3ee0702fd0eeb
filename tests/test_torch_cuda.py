"""The port's CUDA kernels on the card (``cuda`` marker: skipped without a
GPU).  This file imports neither JAX nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain torch version (``kernels/ref.py``)
on the same card tensors: float32 atol = rtol = 2e-5, bfloat16 2e-2 (the
bars of ``tests/test_kernels.py``).  Whole smoke models on the card (the
kernels) are held against the same parameters on the CPU (the
reference's XLA paths) at 2e-4, the bar of ``tests/test_models.py``; so
are the xLSTM smoke model and the application queries (ROADMAP C3).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.spe import _merge_prefill_cache
from repro_torch.kernels import ops, ref
from repro_torch.models import Model

# the kernel modules (their launch counters): the package names resolve to
# ops's callables
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fd = importlib.import_module("repro_torch.kernels.flash_decode")

pytestmark = pytest.mark.cuda

FWD_CASES = [
    # B, S, NH, KV, hd, window, softcap
    (2, 64, 4, 4, 32, 0, 0.0),
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 256, 8, 1, 64, 0, 0.0),
    (1, 128, 4, 2, 32, 32, 0.0),
    (1, 128, 4, 2, 32, 0, 50.0),
    (1, 96, 2, 2, 16, 24, 30.0),      # ragged tile edge
    (1, 300, 8, 4, 256, 100, 50.0),   # gemma2 head_dim, ragged
    (4, 64, 24, 8, 64, 0, 0.0),       # granite-moe prefill, G=3
    (2, 64, 32, 8, 128, 0, 0.0),      # jamba attention layer, G=4
]

DECODE_CASES = [
    # B, S, NH, KV, hd, pos, window, softcap
    (2, 128, 4, 4, 32, 64, 0, 0.0),
    (2, 256, 8, 2, 64, 255, 0, 0.0),
    (1, 512, 8, 1, 64, 0, 0, 0.0),
    (1, 256, 4, 2, 32, 200, 64, 0.0),
    (1, 128, 4, 4, 32, 100, 0, 50.0),
    (4, 80, 28, 4, 128, 70, 0, 0.0),  # qwen2-7b, G=7
    (4, 80, 24, 8, 64, 70, 0, 0.0),   # granite-moe, G=3
    (4, 80, 32, 8, 128, 70, 0, 0.0),  # jamba, G=4
]

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
            for s in shapes]


def close(out, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attention_kernel_vs_plain(case, dtype, cuda):
    B, S, NH, KV, hd, window, cap = case
    q, k, v = (a.to(cuda, dtype) for a in arrays(
        1, (B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = fa.launches
    out = ops.flash_attention(q, k, v, hd ** -0.5, True, window, cap)
    assert fa.launches == before + 1
    close(out, ref.attention(q, k, v, scale=hd ** -0.5, window=window,
                             softcap=cap), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_kernel_vs_plain(case, dtype, cuda):
    B, S, NH, KV, hd, pos, window, cap = case
    q, k, v = (a.to(cuda, dtype) for a in arrays(
        2, (B, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = fd.launches
    out = ops.flash_decode(q, k, v, pos, scale=hd ** -0.5, window=window,
                           softcap=cap)
    assert fd.launches == before + 1
    close(out, ref.decode(q, k, v, pos, scale=hd ** -0.5, window=window,
                          softcap=cap), TOL[dtype])


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_strided_model_cache(kv_dtype, cuda):
    """bf16 q against the model's (B,KV,hd,S) K / (B,KV,S,hd) V caches,
    read through strided (B,S,KV,hd) views with no copy."""
    q, kc, vc = arrays(3, (4, 28, 128), (4, 4, 128, 80), (4, 4, 80, 128))
    q = q.to(cuda, torch.bfloat16)
    kv = kc.to(cuda, kv_dtype).permute(0, 3, 1, 2)
    vv = vc.to(cuda, kv_dtype).permute(0, 2, 1, 3)
    out = ops.flash_decode(q, kv, vv, 70, scale=128 ** -0.5)
    close(out, ref.decode(q, kv, vv, 70, scale=128 ** -0.5), 2e-2)


@pytest.mark.parametrize("S,window,cap", [(96, 0, 0.0), (200, 48, 30.0)])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_attention_bf16_every_head_dim_ragged(hd, S, window, cap,
                                                    cuda):
    """The tensor-core path at every head_dim, with a ragged last tile
    (zero-filled rows) and the window / softcap masks."""
    B, NH, KV = 2, 4, 2
    q, k, v = (a.to(cuda, torch.bfloat16) for a in arrays(
        4, (B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    out = ops.flash_attention(q, k, v, hd ** -0.5, True, window, cap)
    close(out, ref.attention(q, k, v, scale=hd ** -0.5, window=window,
                             softcap=cap), 2e-2)


def test_flash_attention_bf16_unaligned_rows(cuda):
    """Rows that do not start 16-byte aligned are copied before launch."""
    q, k, v = (a.to(cuda, torch.bfloat16) for a in arrays(
        5, (1, 70, 2, 40), (1, 70, 2, 40), (1, 70, 2, 40)))
    q, k, v = q[..., 4:36], k[..., 4:36], v[..., 4:36]   # hd 32, offset 8 B
    out = ops.flash_attention(q, k, v, 32 ** -0.5)
    close(out, ref.attention(q, k, v, scale=32 ** -0.5), 2e-2)


DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]


def decode_caches(seed, B, S, KV, hd, kv_dtype, model_layout):
    """The model's K (B,KV,hd,S) / V (B,KV,S,hd) caches as strided
    (B,S,KV,hd) views, or contiguous (B,S,KV,hd) caches."""
    if model_layout:
        kc, vc = arrays(seed, (B, KV, hd, S), (B, KV, S, hd))
        return (kc.to("cuda", kv_dtype).permute(0, 3, 1, 2),
                vc.to("cuda", kv_dtype).permute(0, 2, 1, 3))
    kc, vc = arrays(seed, (B, S, KV, hd), (B, S, KV, hd))
    return kc.to("cuda", kv_dtype), vc.to("cuda", kv_dtype)


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("model_layout", [True, False])
@pytest.mark.parametrize("pos,window", [(8191, 0), (5000, 1024)])
def test_flash_decode_split_k_long_cache(pos, window, model_layout, q_dtype,
                                         kv_dtype, cuda):
    """An 8k cache: the rule splits it over several blocks per (batch
    row, KV head), and the combine kernel merges them."""
    B, S, NH, KV, hd = 2, 8192, 14, 2, 128
    q = arrays(6, (B, NH, hd))[0].to(cuda, q_dtype)
    kc, vc = decode_caches(7, B, S, KV, hd, kv_dtype, model_layout)
    assert fd.plan(q, kc, pos, window) > 1
    kw = dict(scale=hd ** -0.5, window=window)
    out = ops.flash_decode(q, kc, vc, pos, **kw)
    close(out, ref.decode(q, kc, vc, pos, **kw), TOL[q_dtype])


@pytest.mark.parametrize("S,pos,window", [(2048, 1900, 1000), (256, 100, 0)])
@pytest.mark.parametrize("n_split", [2, 3, 7])
def test_flash_decode_forced_splits_match_decode_split(n_split, S, pos,
                                                       window, cuda,
                                                       monkeypatch):
    """The split and combine kernels against ref.decode_split at the same
    split count (the rule forced to it); at S=256 most of the 7 splits get
    no keys (the combine's guard against all-masked splits)."""
    monkeypatch.setattr(fd, "split_count", lambda *args: n_split)
    B, NH, KV, hd = 2, 8, 2, 64
    q = arrays(8, (B, NH, hd))[0].to(cuda)
    kc, vc = decode_caches(9, B, S, KV, hd, torch.float32, True)
    kw = dict(scale=hd ** -0.5, window=window, softcap=30.0)
    before = fd.launches
    out = fd.flash_decode(q, kc, vc, pos, **kw)
    assert fd.launches == before + 1
    close(out, ref.decode_split(q, kc, vc, pos, n_split=n_split, **kw), 2e-5)
    close(out, ref.decode(q, kc, vc, pos, **kw), 2e-5)


@pytest.mark.parametrize("pos,window", [(2047, 0), (2047, 300), (1000, 0),
                                        (1000, 100)])
@pytest.mark.parametrize("m", [1, 4])
def test_flash_decode_partials_and_combine(pos, window, m, cuda):
    """The partials entry on each of m sequence chunks (a cache split over
    m ranks), the partials combined by the combine entry: each chunk's
    partials against ``ref.decode_split(..., partials=True)`` at the same
    split count and offset, the merged output against ``ref.decode``;
    chunks without a valid key give m = NEG_INF, l = 0."""
    B, NH, KV, hd, S = 2, 8, 2, 64, 2048
    q = arrays(10, (B, NH, hd))[0].to(cuda)
    kc, vc = decode_caches(11, B, S, KV, hd, torch.float32, True)
    kw = dict(scale=hd ** -0.5, window=window, softcap=30.0)
    c = S // m
    before = (fd.partials_launches, fd.combine_launches, fd.launches)
    parts = [fd.partials(q, kc[:, r * c:(r + 1) * c],
                         vc[:, r * c:(r + 1) * c], pos, offset=r * c, **kw)
             for r in range(m)]
    for r, got in enumerate(parts):
        _, want = ref.decode_split(q, kc[:, r * c:(r + 1) * c],
                                   vc[:, r * c:(r + 1) * c], pos,
                                   n_split=got[0].shape[0], partials=True,
                                   offset=r * c, **kw)
        for g, w in zip(got, want):
            close(g, w, 2e-5 * max(float(w.abs().max()), 1.0))
        if ref.chunk_range(pos, window, r * c, c) == (0, 0):
            assert bool((got[1] == ref.NEG_INF).all())
            assert bool((got[2] == 0).all())
    acc, mx, l = (torch.cat([p[i] for p in parts]) for i in range(3))
    out = fd.combine(acc, mx, l, q.dtype)
    assert (fd.partials_launches, fd.combine_launches, fd.launches) == (
        before[0] + m, before[1] + 1, before[2])
    close(out, ref.decode(q, kc, vc, pos, **kw), 2e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 48), device=cuda)     # head_dim 48
    before = (fa.launches, fd.launches)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_decode(q[:, 0], q, q, 3, scale=0.1)
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(q[..., :32].half(), q[..., :32].half(),
                            q[..., :32].half(), 0.1)
    with pytest.raises(ValueError, match="pos"):
        ops.flash_decode(q[:, 0, :, :32].contiguous(), q[..., :32],
                         q[..., :32], 64, scale=0.1)
    assert (fa.launches, fd.launches) == before


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "granite-34b",
                                  "granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_model_on_card_matches_cpu_paths(arch, cuda):
    """float32 compute; the MoE routing, the mamba scan and the attention
    kernels on the card, the plain versions on the CPU."""
    cfg = reduce_for_smoke(get_config(arch))
    cpu = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    before = (fa.launches, fd.launches)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        lg, pc = model.prefill(toks.to(dev))
        cache = _merge_prefill_cache(model.init_cache(2, 48, torch.float32),
                                     pc, 40)
        nxt = toks[:, :1].to(dev)
        ld, _ = model.decode_step(cache, nxt, 40)
        outs.append((lg.cpu(), ld.cpu()))
    n_attn = sum(layer.mixer.startswith("attn") for layer in cfg.layers())
    assert (fa.launches, fd.launches) == (before[0] + n_attn,
                                          before[1] + n_attn)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)


def test_xlstm_on_card_matches_cpu(cuda):
    """Two mLSTM chunks of 128 and 256 sLSTM steps in prefill, then three
    decode steps; no attention kernel runs on this path."""
    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    cpu = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 256)))
    before = (fa.launches, fd.launches)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        lg, pc = model.prefill(toks.to(dev))
        cache = _merge_prefill_cache(model.init_cache(2, 264, torch.float32),
                                     pc, 256)
        steps = [lg.cpu()]
        for i in range(3):
            lg, cache = model.decode_step(cache, toks[:, i:i + 1].to(dev),
                                          256 + i)
            steps.append(lg.cpu())
        outs.append(steps)
    assert (fa.launches, fd.launches) == before
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)


class _R:
    def __init__(self, payload):
        self.payload = payload
        self.size = 64


@pytest.mark.parametrize("name,rows", [
    ("ride_select", [{"area": f"a{i % 7}", "tip": 0.37 * i}
                     for i in range(100)]),
    ("traffic_metrics", [{"service": ["ftp", "web", "dns", "mail"][i % 4],
                          "bytes": 40 + 13 * i} for i in range(77)]),
    ("fraud_svm", [{"x": np.random.default_rng(i).normal(
        1.2, 1.5, 8).tolist()} for i in range(21)]),
])
def test_app_queries_on_card_match_cpu(name, rows, cuda):
    """ROADMAP C3: counts and argmax exact, floats allclose (rtol 1e-6,
    1e-5 for the SVM, atol equal to rtol)."""
    from repro_torch.core.spe import QUERIES
    from repro_torch.core.spec import Component
    out = {}
    for dev in ("cpu", "cuda"):
        q = QUERIES[name](Component("spe", "JAXSTREAM", {"device": dev},
                                    name="spe_t"))
        assert q.device.type == dev
        [(out[dev], _)] = q(None, None, [_R(r) for r in rows])
    if name == "ride_select":   # the argmax, by name
        assert out["cuda"].pop("best_area") == out["cpu"].pop("best_area")
    tol = 1e-5 if name == "fraud_svm" else 1e-6
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# training: the autograd function and train steps on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attention_autograd_on_card(case, dtype, cuda):
    """The forward is the kernel (one launch); given the same upstream
    grad, the grads equal autograd through ref.attention exactly: the
    backward is that same plain recompute."""
    B, S, NH, KV, hd, window, cap = case
    q, k, v, g = (t.to(cuda, dtype) for t in arrays(
        5, (B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, NH, hd)))
    for t in (q, k, v):
        t.requires_grad_()
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=cap)
    before = fa.launches
    out = ops.flash_attention(q, k, v, kw["scale"], True, window, cap)
    assert fa.launches == before + 1
    plain = ref.attention(q, k, v, **kw)
    close(out, plain, TOL[dtype])
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(plain, (q, k, v), g)
    assert fa.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def smoke_grads(model, toks, remat="none"):
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = model.loss(batch)
    return loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_loss_on_card_reaches_attention_weights(arch, cuda):
    """The loss through the kernel's autograd function reaches wq, wk and
    wv (no cut graph) and every gradient matches the CPU's at 2e-4 of the
    model's largest entry (tests/test_torch_train.py); with remat full
    each layer's kernel runs twice (forward, recompute)."""
    cfg = reduce_for_smoke(get_config(arch))
    cpu = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 65)))
    want_loss, want = smoke_grads(cpu, toks)
    for remat, per_layer in (("none", 1), ("full", 2)):
        before = fa.launches
        loss, got = smoke_grads(gpu, toks.to(cuda), remat)
        assert fa.launches == before + per_layer * cfg.n_layers
        torch.testing.assert_close(loss.cpu(), want_loss, atol=2e-4,
                                   rtol=2e-4)
        scale = max(float(w.abs().max()) for w in want.values())
        for key, g in got.items():
            if key.endswith(("mixer.wq", "mixer.wk", "mixer.wv")):
                assert float(g.abs().max()) > 0, key
            torch.testing.assert_close(g.cpu(), want[key], rtol=2e-4,
                                       atol=2e-4 * scale, msg=key)


@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-125m"])
def test_train_steps_on_card_match_cpu(arch, cuda):
    """Three train steps (AdamW, warmup schedule) from the same state on
    the card and on the CPU: losses at rtol 1e-5."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import make_source
    from repro_torch.train import make_step_bundle
    cfg = reduce_for_smoke(get_config(arch))
    bundle = make_step_bundle(cfg, ShapeCfg("t", 32, 2, "train"))
    src = make_source(cfg, 32)
    cpu = bundle.init_fn(torch.Generator().manual_seed(0))
    gpu = bundle.init_fn(torch.Generator(device=cuda).manual_seed(0))
    gpu["params"].load_state_dict(cpu["params"].state_dict())
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in
                 src.batch(i, 0, 2).items()}
        cpu, mc = bundle.step_fn(cpu, batch)
        gpu, mg = bundle.step_fn(gpu, {k: v.to(cuda)
                                       for k, v in batch.items()})
        assert int(mg["step"]) == int(mc["step"]) == i + 1
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                                   rtol=1e-5)


def test_moe_route_slots_on_card_without_host_sync(cuda):
    """``route`` at granite-moe's train shape (4096 tokens, top-8 of 40
    experts, capacity 1.25): the slots (by a stable sort) equal a flat
    token-major one-hot cumsum's, the keep mask is theirs below the
    capacity, and nothing in ``route`` waits for the card."""
    from repro_torch.models import moe
    cfg = get_config("granite-moe-3b-a800m")
    m, D = cfg.moe, cfg.d_model
    T, k, E = 4096, m.top_k, m.padded_experts()
    assert (k, E, m.capacity_factor) == (8, 40, 1.25)
    router, xf = arrays(7, (D, E), (T, D))
    router, xf = (router / D ** 0.5).to(cuda), xf.to(cuda)
    moe.route(router, xf, cfg)                 # warm up the launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, ids, slot, keep = moe.route(router, xf, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    flat = ids.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, E)
    want = torch.gather(torch.cumsum(onehot, 0) - onehot, 1,
                        flat[:, None])[:, 0]
    assert slot.dtype == torch.int64 and slot.shape == (T * k,)
    assert torch.equal(slot, want)
    assert torch.equal(keep, want < moe.capacity_of(m, T))
