"""GQA attention with rope, soft-capping, sliding windows and KV caches.

Counterpart of ``repro/models/attention.py``.  Dispatch is by device:

- a CUDA tensor goes to the hand-written kernels — prefill to
  :func:`repro_torch.kernels.ops.flash_attention`, each decode step to
  :func:`repro_torch.kernels.ops.flash_decode`.  No flag sends a CUDA
  tensor to a plain path.
- a CPU tensor takes the reference's XLA paths, the ones the JAX model
  runs with ``use_pallas=False``: the q-chunked ``_attend_chunk`` (or
  ``_flash_xla`` when ``cfg.attn_impl == "flash_xla"``) and the einsum
  decode.

Decode caches keep the reference's dot-native layouts, K ``(B,KV,hd,S)``
and V ``(B,KV,S,hd)``.  The decode kernel reads them through strided
``(B,S,KV,hd)`` views (no copy).  Unlike the reference's Pallas dispatch
(``attention.py:215``, ROADMAP C1), K is permuted ``(0, 3, 1, 2)``.
Decode updates the caches in place, where the reference returns new
arrays.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.params import dense_init, dtype_of, zeros_init

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """Apply rotary embeddings (split halves, not interleaved).

    x: (..., S, H, hd), positions: (..., S).
    """
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_attn(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init((d, nh * hd)),
        "wk": dense_init((d, nkv * hd)),
        "wv": dense_init((d, nkv * hd)),
        "wo": dense_init((nh * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((nh * hd,))
        p["bk"] = zeros_init((nkv * hd,))
        p["bv"] = zeros_init((nkv * hd,))
    return p


def _qk_scale(cfg) -> float:
    if cfg.query_pre_attn_scalar:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.head_dim_ ** -0.5


def _softcap(logits, cap: float):
    if cap:
        return cap * torch.tanh(logits / cap)
    return logits


# ---------------------------------------------------------------------------
# Full-sequence attention: CPU paths (the reference's XLA paths)
# ---------------------------------------------------------------------------


def _attend_chunk(q, k, v, cfg, window: int, chunk_positions):
    """q: (B,Cq,KV,G,hd); k,v: (B,S,KV,hd).  Returns (B,Cq,KV,G,hd)."""
    scale = _qk_scale(cfg)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float() * scale, k.float())
    logits = _softcap(logits, cfg.attn_softcap)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = chunk_positions[:, None] >= kv_pos[None, :]   # (Cq, S)
    if window:
        mask &= (chunk_positions[:, None] - kv_pos[None, :]) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def _flash_xla(q, k, v, cfg, window: int, *, q_chunk: int = 1024,
               k_chunk: int = 512):
    """Online softmax over k-blocks, per q-chunk (mirror of the XLA path)."""
    B, S, KV, G, hd = q.shape
    scale = _qk_scale(cfg)
    nq = max(1, S // q_chunk)
    while S % nq:
        nq -= 1
    Cq = S // nq
    nk = max(1, S // k_chunk)
    while S % nk:
        nk -= 1
    Ck = S // nk
    outs = []
    for qi in range(nq):
        qs = q[:, qi * Cq:(qi + 1) * Cq].float() * scale
        qpos = qi * Cq + torch.arange(Cq, device=q.device)
        acc = torch.zeros((B, KV, G, Cq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, Cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, Cq), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            kc = k[:, ki * Ck:(ki + 1) * Ck].float()
            vc = v[:, ki * Ck:(ki + 1) * Ck].float()
            s = torch.einsum("bqkgh,bskh->bkgqs", qs, kc)
            s = _softcap(s, cfg.attn_softcap)
            kpos = ki * Ck + torch.arange(Ck, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,Cq,KV,G,hd)
    return torch.cat(outs, dim=1).reshape(B, S, KV * G, hd)


def full_attention(q, k, v, cfg, *, window: int = 0, q_chunk: int = 1024):
    """q: (B,S,NH,hd), k/v: (B,S,KV,hd) -> (B,S,NH,hd), causal (+window)."""
    B, S, NH, hd = q.shape
    if q.device.type == "cuda":
        return kops.flash_attention(q, k, v, _qk_scale(cfg), True, window,
                                    cfg.attn_softcap)
    KV = k.shape[2]
    q = q.reshape(B, S, KV, NH // KV, hd)
    if cfg.attn_impl == "flash_xla":
        return _flash_xla(q, k, v, cfg, window, q_chunk=q_chunk)
    if S <= q_chunk:
        pos = torch.arange(S, device=q.device)
        return _attend_chunk(q, k, v, cfg, window, pos).reshape(B, S, NH, hd)
    assert S % q_chunk == 0, (S, q_chunk)
    outs = [_attend_chunk(q[:, i:i + q_chunk], k, v, cfg, window,
                          i + torch.arange(q_chunk, device=q.device))
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, NH, hd)


# ---------------------------------------------------------------------------
# Decode attention against a KV cache
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos: int, cfg, *, window: int = 0):
    """q: (B,1,NH,hd); k cache: (B,KV,hd,Smax); v cache: (B,KV,Smax,hd).

    The CPU path returns float32, as the reference's XLA path does;
    the kernel returns q's dtype (``attn_apply`` casts both alike).
    """
    B, _, NH, hd = q.shape
    KV, Smax = k_cache.shape[1], k_cache.shape[3]
    G = NH // KV
    if q.device.type == "cuda":
        return kops.flash_decode(
            q[:, 0], k_cache.permute(0, 3, 1, 2), v_cache.permute(0, 2, 1, 3),
            pos, scale=_qk_scale(cfg), window=window,
            softcap=cfg.attn_softcap)[:, None]
    qh = q.reshape(B, KV, G, hd).float() * _qk_scale(cfg)
    logits = torch.einsum("bkgh,bkhs->bkgs", qh, k_cache.float())
    logits = _softcap(logits, cfg.attn_softcap)
    kv_pos = torch.arange(Smax, device=q.device)
    valid = kv_pos <= pos
    if window:
        valid &= (pos - kv_pos) < window
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", probs, v_cache.float())
    return out.reshape(B, 1, NH, hd)


# ---------------------------------------------------------------------------
# Attention block apply (projections + rope + attend + output proj)
# ---------------------------------------------------------------------------


def attn_apply(params, x, cfg, *, local: bool, positions=None,
               cache: Optional[dict] = None, cache_pos: Optional[int] = None,
               return_kv: bool = False):
    """x: (B,S,D).  If cache is given, S must be 1 (decode step).

    With ``return_kv`` (prefill), the full-sequence post-rope K/V are
    returned in the decode layouts alongside the output.  A decode step
    writes position ``cache_pos`` of ``cache`` in place and returns it.
    """
    cdt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x = x.to(cdt)
    q = x @ params["wq"].to(cdt)
    k = x @ params["wk"].to(cdt)
    v = x @ params["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)

    window = cfg.sliding_window if local else 0

    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = full_attention(q, k, v, cfg, window=window)
        new_cache = None
        if return_kv:       # decode-layout caches (see decode_attention)
            new_cache = {"k": k.permute(0, 2, 3, 1),
                         "v": v.permute(0, 2, 1, 3)}
    else:
        assert S == 1
        pos = int(cache_pos)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        cache["k"][:, :, :, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, :, pos, :] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], pos, cfg,
                               window=window)
        new_cache = cache

    out = out.reshape(B, S, nh * hd).to(cdt)
    return out @ params["wo"].to(cdt), new_cache


def init_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None):
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((batch, kv, hd, max_len), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, kv, max_len, hd), dtype=dtype,
                             device=device)}
