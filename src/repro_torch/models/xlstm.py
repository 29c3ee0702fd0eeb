"""xLSTM blocks: mLSTM (matrix memory, chunkwise) and sLSTM (scalar
memory, sequential).

Counterpart of ``repro/models/xlstm.py``, function by function.  The
mLSTM forward is the stabilized chunkwise-parallel form: within a chunk
a (Q, Q) decay-weighted attention matrix, across chunks a Python loop
(the reference's ``lax.scan``) that carries the (heads, dh, dh) matrix
memory.  The sLSTM runs a Python loop over time with per-head
block-diagonal recurrent weights.  Recurrent states are float32 whatever
the compute dtype; decode returns new state tensors.

The stabilizer starts at -1e30 and the intra-chunk decay matrix is
masked with -inf before ``exp``, as in the reference: both enter
``exp(-m_t)`` in the denominator's floor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import (
    const_init, dense_init, dtype_of, ones_init, zeros_init,
)
from repro_torch.models.ssm import _causal_conv

M_INIT = -1e30  # initial stabilizer of both cells


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner_mlstm
    H = cfg.n_heads
    K = cfg.xlstm.conv_dim
    return {
        "up_proj": dense_init((d, 2 * di)),
        "conv_w": dense_init((K, di)),
        "conv_b": zeros_init((di,)),
        "wq": dense_init((di, di)),
        "wk": dense_init((di, di)),
        "wv": dense_init((di, di)),
        "w_if": dense_init((di, 2 * H)),
        "b_i": zeros_init((H,), dtype="float32"),
        "b_f": const_init((H,), 3.0, dtype="float32"),
        "skip": ones_init((di,)),
        "norm_scale": ones_init((di,)),
        "down_proj": dense_init((di, d)),
    }


def _headwise_rmsnorm(h, scale, eps=1e-6):
    """h: (B,S,H,dh); per-head RMS norm with a flat (di,) scale."""
    B, S, H, dh = h.shape
    hf = h.float()
    var = torch.mean(hf * hf, dim=-1, keepdim=True)
    hn = hf * torch.rsqrt(var + eps)
    return (hn.reshape(B, S, H * dh) * scale.float()).to(h.dtype)


def mlstm_scan(q, k, v, logi, logf, state=None, chunk: int = 128):
    """Stabilized chunkwise mLSTM.

    q,k,v: (B,S,H,dh); logi/logf: (B,S,H) log input/forget gates.
    state: (C (B,H,dh,dh), n (B,H,dh), m (B,H)).
    Returns h (B,S,H,dh) float32 and the final state.
    """
    B, S, H, dh = q.shape
    f32 = torch.float32
    q = q.float() * (dh ** -0.5)
    k = k.float()
    v = v.float()
    logi = logi.float()
    logf = logf.float()

    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=f32, device=q.device)
        n = torch.zeros((B, H, dh), dtype=f32, device=q.device)
        m = torch.full((B, H), M_INIT, dtype=f32, device=q.device)
    else:
        C, n, m = state

    assert S % chunk == 0 or S < chunk, (S, chunk)
    Q = min(chunk, S)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, S, Q):
        qc, kc, vc = q[:, c0:c0 + Q], k[:, c0:c0 + Q], v[:, c0:c0 + Q]
        li, lf = logi[:, c0:c0 + Q], logf[:, c0:c0 + Q]  # (B,Q,H)
        b = torch.cumsum(lf, dim=1)                    # (B,Q,H) inclusive
        g = torch.cummax(li - b, dim=1).values         # running max of i-b
        m_t = b + torch.maximum(m[:, None], g)         # (B,Q,H) row stabilizer
        # inter-chunk: q_t . C_prev, scaled
        inter_scale = torch.exp(b + m[:, None] - m_t)
        num_inter = (torch.einsum("bqhd,bhde->bqhe", qc, C)
                     * inter_scale[..., None])
        den_inter = torch.einsum("bqhd,bhd->bqh", qc, n) * inter_scale
        # intra-chunk decay matrix: D[t,s] = exp(b_t - b_s + i_s - m_t), s<=t
        dmat = (b[:, :, None] - b[:, None, :]
                + li[:, None, :] - m_t[:, :, None])    # (B,Q,Q,H)
        dmat = dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
        scores = torch.einsum("bqhd,bshd->bqsh", qc, kc) * torch.exp(dmat)
        num = num_inter + torch.einsum("bqsh,bshd->bqhd", scores, vc)
        den = den_inter + scores.sum(dim=2)            # (B,Q,H)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_t))[..., None])
        # carry update (to end of chunk)
        bQ = b[:, -1]                                  # (B,H)
        m_new = bQ + torch.maximum(m, g[:, -1])
        c_scale = torch.exp(bQ + m - m_new)            # (B,H)
        k_scale = torch.exp(bQ[:, None] - b + li - m_new[:, None])
        ks = kc * k_scale[..., None]
        C = (C * c_scale[..., None, None]
             + torch.einsum("bqhd,bqhe->bhde", ks, vc))
        n = n * c_scale[..., None] + ks.sum(dim=1)
        m = m_new
    return torch.cat(hs, dim=1), (C, n, m)


def mlstm_decode_step(q, k, v, logi, logf, state):
    """One-token mLSTM update.  q,k,v: (B,H,dh); logi/logf: (B,H)."""
    C, n, m = state
    dh = q.shape[-1]
    q = q.float() * (dh ** -0.5)
    k = k.float()
    v = v.float()
    m_new = torch.maximum(logf + m, logi)
    f_sc = torch.exp(logf + m - m_new)
    i_sc = torch.exp(logi - m_new)
    C_new = C * f_sc[..., None, None] + torch.einsum(
        "bhd,bhe->bhde", k * i_sc[..., None], v)
    n_new = n * f_sc[..., None] + k * i_sc[..., None]
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C_new, n_new, m_new)


def mlstm_apply(params, x, cfg, cache: Optional[dict] = None,
                return_state: bool = False):
    """x: (B,S,D).  cache: {"conv": (B,K-1,di), "C","n","m"}."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    di = cfg.d_inner_mlstm
    H = cfg.n_heads
    dh = di // H

    xz = x.to(cdt) @ params["up_proj"].to(cdt)
    xm, z = torch.chunk(xz, 2, dim=-1)

    conv_cache = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(
        xm, params["conv_w"].to(cdt), params["conv_b"].to(cdt), conv_cache)
    xc = F.silu(xc)

    q = (xc @ params["wq"].to(cdt)).reshape(B, S, H, dh)
    k = (xc @ params["wk"].to(cdt)).reshape(B, S, H, dh)
    v = (xm @ params["wv"].to(cdt)).reshape(B, S, H, dh)
    gates = (xm @ params["w_if"].to(cdt)).float()
    logi = gates[..., :H] + params["b_i"][None, None]
    logf = F.logsigmoid(gates[..., H:] + params["b_f"][None, None])

    if cache is None:
        h, (C, n, m) = mlstm_scan(q, k, v, logi, logf)
        if return_state:
            # the conv state is the last K-1 pre-conv inputs
            K = cfg.xlstm.conv_dim
            new_conv = xm[:, -(K - 1):].to(cdt)
    else:
        state = (cache["C"], cache["n"], cache["m"])
        h, (C, n, m) = mlstm_decode_step(
            q[:, 0], k[:, 0], v[:, 0], logi[:, 0], logf[:, 0], state)
        h = h[:, None]

    h = _headwise_rmsnorm(h.to(cdt), params["norm_scale"])
    h = h + params["skip"].to(cdt)[None, None] * xc
    out = (h * F.silu(z)) @ params["down_proj"].to(cdt)
    if cache is None and not return_state:
        return out, None
    return out, {"conv": new_conv, "C": C, "n": n, "m": m}


def init_mlstm_cache(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    di = cfg.d_inner_mlstm
    H = cfg.n_heads
    dh = di // H
    K = cfg.xlstm.conv_dim
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), M_INIT, dtype=f32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    hf = int(cfg.xlstm.slstm_proj_factor * d)
    return {
        # input weights for gates (i, f, z, o)
        "w": dense_init((d, 4 * d)),
        # block-diagonal (per-head) recurrent weights for 4 gates
        "r": dense_init((4, H, dh, dh), dtype="float32", scale=0.05),
        "b": const_init((4 * d,), 0.0, 3.0, 0.0, 0.0, dtype="float32"),
        "norm_scale": ones_init((d,)),
        "ffn_up": dense_init((d, hf)),
        "ffn_down": dense_init((hf, d)),
    }


def _slstm_cell(carry, wx, r):
    """One sLSTM step.  wx: (B,4,H,dh) pre-activations from the input path.
    carry: (c, n, h, m), each (B,H,dh)."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,ghde->bghe", h, r)  # (B,4,H,dh)
    i_raw, f_raw, z_raw, o_raw = (wx + rec).unbind(1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_sc = torch.exp(i_raw - m_new)
    f_sc = torch.exp(logf + m - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(z_raw)
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new)


def slstm_apply(params, x, cfg, cache: Optional[dict] = None,
                return_state: bool = False):
    """x: (B,S,D).  A Python loop over time (sLSTM is not parallelizable)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H

    wx = (x.to(cdt) @ params["w"].to(cdt)).float()
    wx = (wx + params["b"][None, None]).reshape(B, S, 4, H, dh)
    r = params["r"]

    if cache is None:
        carry = init_slstm_cache(cfg, B, device=x.device)
        carry = (carry["c"], carry["n"], carry["h"], carry["m"])
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])

    hs = []
    for t in range(S):
        carry = _slstm_cell(carry, wx[:, t], r)
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(cdt)

    # post-norm + gelu FFN (sLSTM block's post up/down projection)
    hf = h.float()
    var = torch.mean(hf * hf, dim=-1, keepdim=True)
    hn = (hf * torch.rsqrt(var + 1e-6)
          * params["norm_scale"].float()).to(cdt)
    # jax.nn.gelu defaults to the tanh approximation
    out = F.gelu(hn @ params["ffn_up"].to(cdt), approximate="tanh") \
        @ params["ffn_down"].to(cdt)

    new_cache = None
    if cache is not None or return_state:
        new_cache = {"c": carry[0], "n": carry[1], "h": carry[2],
                     "m": carry[3]}
    return out, new_cache


def init_slstm_cache(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    """All four states are float32 (``dtype`` is taken for the signature
    that every mixer's cache shares).  Separate tensors: a prefill merge
    writes each one in place."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    shape = (batch, H, dh)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full(shape, M_INIT, dtype=torch.float32,
                            device=device)}
