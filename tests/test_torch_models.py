"""The port's model pieces and whole dense models against the JAX package.

Inputs and parameters are made once (numpy, or the reference's own init
converted with :func:`from_jax_params`) and fed to both packages.  On
the CPU the port takes the reference's XLA paths, i.e. what the JAX model
runs with ``use_pallas=False`` (the smoke configs force that), so the
reference's Pallas decode dispatch and its K-layout fault (ROADMAP C1)
are not exercised here.  Tolerances: float32 atol = rtol = 2e-5 for
single layers, 2e-4 for whole-model logits (the bar of
``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.core.spe import _merge_prefill_cache as jmerge
from repro.models import Model as JModel
from repro.models import attention as jattn, layers as jlayers
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.spe import _merge_prefill_cache
from repro_torch.models import Model
from repro_torch.models import attention as attn, layers
from repro_torch.models.params import from_jax_params, resolve_device

DENSE = ["qwen2-7b", "gemma2-2b", "granite-34b", "pixtral-12b",
         "musicgen-large", "gemma2-27b"]


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def close(port, want, tol=2e-5):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def both_params(d: dict):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


def cfgs(arch):
    """(reference config, port config) at smoke size, float32."""
    return jreduce(jget(arch)), reduce_for_smoke(get_config(arch))


def jax_model(arch, seed):
    jcfg, cfg = cfgs(arch)
    jm = JModel(jcfg)
    tree = jm.init_params(jax.random.key(seed))
    port = Model(cfg, device="cpu")
    port.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                           tree)))
    return jm, tree, port


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zc", [False, True])
def test_rmsnorm(zc):
    x, s = arrays(0, (2, 7, 64), (64,))
    jp, tp = both_params({"scale": s})
    close(layers.rmsnorm(tp, torch.from_numpy(x), 1e-6, zero_centered=zc),
          jlayers.rmsnorm(jp, jnp.asarray(x), 1e-6, zero_centered=zc))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "granite-34b"])
def test_mlp(arch):
    """gated silu (qwen2), gated tanh-gelu (gemma2), plain gelu (granite)"""
    jcfg, cfg = cfgs(arch)
    d, f = cfg.d_model, cfg.d_ff
    x, up, down, gate = arrays(1, (2, 5, d), (d, f), (f, d), (d, f))
    p = {"w_up": up / np.sqrt(d), "w_down": down / np.sqrt(f)}
    if cfg.gated_mlp:
        p["w_gate"] = gate / np.sqrt(d)
    jp, tp = both_params(p)
    close(layers.mlp(tp, torch.from_numpy(x), cfg),
          jlayers.mlp(jp, jnp.asarray(x), jcfg), 2e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_embed_and_logits(arch):
    """untied head (qwen2); embed_scale, tied head, final softcap
    (gemma2)"""
    jcfg, cfg = cfgs(arch)
    emb, unemb, x = arrays(2, (cfg.vocab_size, cfg.d_model),
                           (cfg.d_model, cfg.vocab_size), (2, 3, cfg.d_model))
    p = {"embedding": emb}
    if not cfg.tie_embeddings:
        p["unembed"] = unemb
    jp, tp = both_params(p)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    close(layers.embed(tp, torch.from_numpy(toks), cfg),
          jlayers.embed(jp, jnp.asarray(toks), jcfg))
    close(layers.logits(tp, torch.from_numpy(x), cfg),
          jlayers.logits(jp, jnp.asarray(x), jcfg), 1e-4)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def test_rope():
    x, = arrays(4, (2, 24, 3, 32))
    pos = np.arange(24)[None] + np.array([[0], [100]])
    close(attn.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          jattn.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 2e-5)


@pytest.mark.parametrize("arch,S,q_chunk,impl", [
    ("qwen2-7b", 48, 1024, "chunked"),    # S <= q_chunk: one chunk
    ("qwen2-7b", 96, 32, "chunked"),      # chunked over queries
    ("gemma2-2b", 96, 32, "chunked"),     # window + softcap, chunked
    ("gemma2-2b", 96, 32, "flash_xla"),   # online-softmax XLA path
])
def test_full_attention(arch, S, q_chunk, impl):
    jcfg, cfg = cfgs(arch)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, sliding_window=24)
    cfg = dataclasses.replace(cfg, attn_impl=impl, sliding_window=24)
    NH, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = arrays(5, (2, S, NH, hd), (2, S, KV, hd), (2, S, KV, hd))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for window in (0, cfg.sliding_window):
        close(attn.full_attention(tq, tk, tv, cfg, window=window,
                                  q_chunk=q_chunk),
              jattn.full_attention(jq, jk, jv, jcfg, window=window,
                                   q_chunk=q_chunk))
        if impl == "flash_xla":   # several k-blocks as well
            G = NH // KV
            close(attn._flash_xla(tq.reshape(2, S, KV, G, hd), tk, tv, cfg,
                                  window, q_chunk=q_chunk, k_chunk=32),
                  jattn._flash_xla(jq.reshape(2, S, KV, G, hd), jk, jv,
                                   jcfg, window, q_chunk=q_chunk,
                                   k_chunk=32))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
@pytest.mark.parametrize("pos,window", [(0, 0), (37, 0), (37, 16)])
def test_decode_attention(arch, pos, window):
    """Reference cache layouts K (B,KV,hd,S), V (B,KV,S,hd); the reference
    runs its einsum path (use_pallas=False: see ROADMAP C1)."""
    jcfg, cfg = cfgs(arch)
    NH, KV, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, 48
    q, kc, vc = arrays(6, (2, 1, NH, hd), (2, KV, hd, S), (2, KV, S, hd))
    port = attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), pos, cfg,
                                 window=window)
    assert port.dtype == torch.float32    # as the XLA path returns
    close(port, jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.int32(pos),
                                       jcfg, window=window))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_attn_apply_prefill_and_decode(arch):
    jcfg, cfg = cfgs(arch)
    d, NH, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x, x1, wq, wk, wv, wo, bq, bk, bv = arrays(
        7, (2, 20, d), (2, 1, d), (d, NH * hd), (d, KV * hd), (d, KV * hd),
        (NH * hd, d), (NH * hd,), (KV * hd,), (KV * hd,))
    p = {"wq": wq / 8, "wk": wk / 8, "wv": wv / 8, "wo": wo / 8}
    if cfg.qkv_bias:
        p.update(bq=bq, bk=bk, bv=bv)
    jp, tp = both_params(p)
    for local in (False, True):
        out, kv = attn.attn_apply(tp, torch.from_numpy(x), cfg, local=local,
                                  return_kv=True)
        jout, jkv = jattn.attn_apply(jp, jnp.asarray(x), jcfg, local=local,
                                     return_kv=True)
        close(out, jout, 1e-4)
        close(kv["k"], jkv["k"], 1e-4)
        close(kv["v"], jkv["v"], 1e-4)
        cache = attn.init_attn_cache(cfg, 2, 32, torch.float32)
        jcache = jattn.init_attn_cache(jcfg, 2, 32, jnp.float32)
        cache = _merge_prefill_cache(cache, kv, 20)
        jcache = jmerge(jcache, jkv, 20)
        out, cache = attn.attn_apply(tp, torch.from_numpy(x1), cfg,
                                     local=local, cache=cache, cache_pos=20)
        jout, jcache = jattn.attn_apply(jp, jnp.asarray(x1), jcfg,
                                        local=local, cache=jcache,
                                        cache_pos=jnp.int32(20))
        close(out, jout, 1e-4)
        close(cache["k"], jcache["k"], 1e-4)
        close(cache["v"], jcache["v"], 1e-4)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_state_dict_follows_jax_tree_paths(arch):
    jcfg, cfg = cfgs(arch)
    tree = jax.eval_shape(JModel(jcfg).init_params, jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    want = {k: tuple(v.shape) for k, v in from_jax_params(cfg, tree).items()}
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert "groups.1.l0.mixer.wq" in want
    # the initializers' distributions: dense N(0, 1/fan_in), embed
    # N(0, 0.02^2), zero biases, unit norm scales
    sd = model.state_dict()
    wq = sd["groups.0.l0.mixer.wq"]
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.1
    assert abs(sd["embed.embedding"].std().item() / 0.02 - 1) < 0.1
    assert torch.all(sd["final_norm.scale"] == 1)
    if cfg.qkv_bias:
        assert torch.all(sd["groups.0.l0.mixer.bq"] == 0)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    """Token inputs, or (B, S, D) float embeddings for the configs with
    ``input_mode="embeddings"`` (pixtral-12b, musicgen-large)."""
    jm, tree, port = jax_model(arch, 1)
    cfg = port.cfg
    B, S = 2, 16
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        as_port = lambda a: torch.from_numpy(a).long()  # noqa: E731
    else:
        toks = rng.normal(0, 1, (B, S + 1, cfg.d_model)).astype(np.float32)
        as_port = torch.from_numpy
    jl, jc = jax.jit(jm.prefill)(tree, jnp.asarray(toks[:, :S]))
    tl, tc = port.prefill(as_port(toks[:, :S]))
    close(tl, jl, 2e-4)
    jfull = jmerge(jm.init_cache(B, S + 8, jnp.float32), jc, S)
    tfull = _merge_prefill_cache(port.init_cache(B, S + 8, torch.float32),
                                 tc, S)
    nxt = (np.array(jnp.argmax(jl[:, -1], -1))[:, None]
           if cfg.input_mode == "tokens" else toks[:, S:])
    jd, jfull = jax.jit(jm.decode_step)(tree, jfull, jnp.asarray(nxt),
                                        jnp.int32(S))
    td, tfull = port.decode_step(tfull, as_port(nxt), S)
    close(td, jd, 2e-4)
    for g in range(cfg.n_groups):
        for name in ("k", "v"):
            close(tfull[g]["l0"]["mixer"][name],
                  jfull["l0"]["mixer"][name][g], 2e-4)


def test_prefill_decode_consistency():
    """Decode at position S must match a fresh prefill of S+1 tokens
    (the port's version of ``tests/test_models.py``'s test)."""
    cfg = reduce_for_smoke(get_config("qwen2-7b"))
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 17)))
    la, _ = model.prefill(toks)
    _, pc = model.prefill(toks[:, :16])
    cache = _merge_prefill_cache(model.init_cache(1, 32, torch.float32),
                                 pc, 16)
    ld, _ = model.decode_step(cache, toks[:, 16:17], 16)
    close(ld[:, -1], la[:, -1].numpy(), 2e-4)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
