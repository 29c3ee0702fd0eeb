"""Plain torch oracles for the attention kernels.

These deliberately materialize the full (Sq, Sk) score matrix — they are
the *semantic* references the CUDA kernels are tested against, and the
path a kernel wrapper takes for a tensor that lies on the CPU.  They run
on any device, so ``chip_smoke.py`` also holds the kernels against them
on the card.  Counterparts of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _mask(sq: int, sk: int, *, causal: bool, window: int, device,
          q_offset: int = 0):
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= (qpos - kpos) < window
    return m


def attention(q, k, v, *, scale: float, causal: bool = True,
              window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, NH, hd); k, v: (B, Sk, KV, hd).  GQA via head groups.

    Returns (B, Sq, NH, hd) in q.dtype; softmax in f32.
    """
    B, Sq, NH, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = NH // KV
    qg = q.reshape(B, Sq, KV, G, hd).float() * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, NH, hd).to(q.dtype)


def decode(q, k_cache, v_cache, pos: int, *, scale: float, window: int = 0,
           softcap: float = 0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd) (any strides); pos: int.

    Attends to cache positions <= pos (inclusive).  Returns (B, NH, hd)
    in q.dtype.
    """
    B, NH, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = NH // KV
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    valid = kpos <= pos
    if window:
        valid &= (pos - kpos) < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, NH, hd).to(q.dtype)


def rmsnorm(x, scale, *, eps: float = 1e-6, zero_centered: bool = False):
    """x: (..., D); scale: (D,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    sf = scale.float()
    if zero_centered:
        sf = 1.0 + sf
    return (xf * torch.rsqrt(var + eps) * sf).to(x.dtype)
