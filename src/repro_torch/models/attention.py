"""GQA attention with rope, soft-capping, sliding windows and KV caches.

Counterpart of ``repro/models/attention.py``.  Dispatch is by device:

- a CUDA tensor goes to the hand-written kernels — prefill to
  :func:`repro_torch.kernels.ops.flash_attention`, each decode step to
  :func:`repro_torch.kernels.ops.flash_decode`.  No flag sends a CUDA
  tensor to a plain path.  (A dry run's fake meta tensors go there too,
  inside ``kernels.ops.card_program``: ``kernels.ops.on_card``.)
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

Under the mesh step's tensor-parallel plan ("heads" split over
``model``) a layer computes this rank's query heads: ``wq``/``bq`` are
its columns and ``wo`` its rows (f before, g after).  ``wk``/``wv`` are
its columns too when the KV heads split as well ("kv_heads"); otherwise
the rank computes, from the whole leaves, the KV heads its query heads
read (query head h reads KV head h // G), and their gradient is summed
over the ranks.  ``flash_attention`` then runs on the local heads.
Under the sequence split (``seq_shard``) the layer gathers the residual
stream's positions before its projections and reduce-scatters ``wo``'s
partial output back to them (``sublayer_in`` / ``sublayer_out``), so the
heads attend over the whole sequence and a prefill returns the whole
sequence's K/V, as without it.

Serving on a mesh (the prefill and decode bundles of ``train/steps.py``)
keeps the decode cache split over ``model`` in one of two ways:

- by KV heads, when the plan splits them: each rank computes, writes and
  attends its own KV heads with its query heads, as above;
- otherwise every rank's cache holds every KV head: by sequence when
  ``current_cache_seq()`` says so (``cache_seq`` on ``model``; rank r
  holds keys ``r * S_l .. (r + 1) * S_l - 1``), else whole.  Each rank
  computes every KV head's K/V from the whole ``wk``/``wv`` (a prefill
  returns them all, and the bundle keeps the rank's chunk); a decode
  step writes ``pos`` on the rank whose chunk holds it.  Attention
  gathers the query heads over ``model``; on a sequence split it runs
  ``flash_decode``'s partials entry on the rank's chunk, with ``pos``
  and the window in global coordinates, gathers the float32 partials
  (acc, m, l) over ``model`` and merges them with the combine entry.
  The rank keeps its own query heads for ``wo``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.collectives import copy_to, gathered
from repro_torch.distributed.sharding import (
    current_cache_seq, current_tp, sublayer_in, sublayer_out,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_decode import combine, partials
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
        "wq": dense_init((d, nh * hd), ("embed", "q_features")),
        "wk": dense_init((d, nkv * hd), ("embed", "kv_features")),
        "wv": dense_init((d, nkv * hd), ("embed", "kv_features")),
        "wo": dense_init((nh * hd, d), ("q_features", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((nh * hd,), ("q_features",))
        p["bk"] = zeros_init((nkv * hd,), ("kv_features",))
        p["bv"] = zeros_init((nkv * hd,), ("kv_features",))
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
    if kops.on_card(q):
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
    if kops.on_card(q):
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
    tp = current_tp("heads")
    x = sublayer_in(x.to(cdt), tp)
    B, S, _ = x.shape
    # serving with the query heads split and the KV heads not: the cache
    # holds every KV head (see the module doc)
    all_kv = (tp is not None and current_tp("kv_heads") is None
              and (cache is not None or return_kv))
    q, k, v = _qkv(params, x, cfg, tp, all_kv=all_kv)

    window = cfg.sliding_window if local else 0

    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ka, va = (k, v) if not all_kv else _read_heads(k, v, tp.rank,
                                                       q.shape[2], cfg)
        out = full_attention(q, ka, va, cfg, window=window)
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
        seq = current_cache_seq()
        S_l = cache["k"].shape[3]
        at = pos - (0 if seq is None else seq.rank * S_l)
        if 0 <= at < S_l:           # this rank's chunk holds pos
            cache["k"][:, :, :, at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, :, at, :] = v[:, 0].to(cache["v"].dtype)
        if all_kv or seq is not None:
            out = _decode_every_kv_head(q, cache, pos, cfg, window, tp, seq)
        else:
            out = decode_attention(q, cache["k"], cache["v"], pos, cfg,
                                   window=window)
        new_cache = cache

    out = out.reshape(B, S, -1).to(cdt) @ params["wo"].to(cdt)
    return sublayer_out(out, tp), new_cache


def _kv_read(rank: int, nh: int, cfg):
    """The KV heads that query heads ``rank * nh .. (rank + 1) * nh - 1``
    read: (their columns of ``wk``/``wv``, None when the local heads keep
    a uniform GQA grouping over them, else the head each local query head
    reads among them)."""
    G, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_
    lo = rank * nh
    kv_lo, kv_hi = lo // G, (lo + nh - 1) // G + 1
    read = [(lo + i) // G - kv_lo for i in range(nh)]
    n = kv_hi - kv_lo
    uniform = nh % n == 0 and read == [i // (nh // n) for i in range(nh)]
    return slice(kv_lo * hd, kv_hi * hd), None if uniform else read


def _read_heads(k, v, rank: int, nh: int, cfg):
    """Of k and v (B,S,KV,hd) with every KV head, the heads that query
    heads ``rank * nh .. (rank + 1) * nh - 1`` read (see :func:`_kv_read`),
    one per local query head where their grouping is not uniform."""
    hd = cfg.head_dim_
    cols, read = _kv_read(rank, nh, cfg)
    heads = slice(cols.start // hd, cols.stop // hd)
    k, v = k[:, :, heads], v[:, :, heads]
    return (k, v) if read is None else (k[:, :, read], v[:, :, read])


def _decode_every_kv_head(q, cache, pos: int, cfg, window: int, tp, seq):
    """Decode attention of this rank's query heads q (B,1,nh,hd) against a
    cache that holds every KV head: its whole sequence, or with ``seq``
    this rank's chunk of it (keys ``rank * S_l ..``), whose partials are
    merged over ``model`` (see the module doc)."""
    nh = q.shape[2]
    if tp is not None:
        q = gathered(q, tp.group, 2)            # (B,1,NH,hd)
    if seq is None:
        out = decode_attention(q, cache["k"], cache["v"], pos, cfg,
                               window=window)
    else:
        kc = cache["k"].permute(0, 3, 1, 2)     # (B,S_l,KV,hd) views
        vc = cache["v"].permute(0, 2, 1, 3)
        acc, m, l = partials(q[:, 0], kc, vc, pos,
                             offset=seq.rank * kc.shape[1],
                             scale=_qk_scale(cfg), window=window,
                             softcap=cfg.attn_softcap)
        out = combine(*(gathered(t, seq.group, 0) for t in (acc, m, l)),
                      q.dtype)[:, None]
    return out if tp is None else out[:, :, tp.rank * nh:(tp.rank + 1) * nh]


def _qkv(params, x, cfg, tp, *, all_kv: bool = False):
    """q (B,S,NH,hd), k and v (B,S,KV,hd) of x (B,S,D), the sublayer's
    input (``sublayer_in``), in the compute dtype: every head, or with
    ``tp`` this rank's query heads and their KV heads, or (``all_kv``)
    every KV head (see the module doc)."""
    B, S, _ = x.shape
    cdt, hd = x.dtype, cfg.head_dim_
    w = {n: params[n] for n in ("wq", "wk", "wv")}
    if cfg.qkv_bias:
        w.update({n: params[n] for n in ("bq", "bk", "bv")})
    read = None
    if tp is not None:
        if current_tp("kv_heads") is None and not all_kv:
            cols, read = _kv_read(tp.rank, w["wq"].shape[1] // hd, cfg)
            for n in ("wk", "wv", "bk", "bv"):
                if n in w:
                    w[n] = copy_to(w[n], tp.group)[..., cols]

    def proj(n):
        y = x @ w["w" + n].to(cdt)
        if cfg.qkv_bias:
            y = y + w["b" + n].to(cdt)
        return y.reshape(B, S, -1, hd)

    q, k, v = proj("q"), proj("k"), proj("v")
    if read is not None:
        k, v = k[:, :, read], v[:, :, read]
    return q, k, v


def init_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None):
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((batch, kv, hd, max_len), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, kv, max_len, hd), dtype=dtype,
                             device=device)}


def attn_cache_axes() -> dict:
    return {"k": ("batch", "kv_heads", "head_dim", "cache_seq"),
            "v": ("batch", "kv_heads", "cache_seq", "head_dim")}
