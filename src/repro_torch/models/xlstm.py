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

Tensor parallelism over ``model`` (``distributed/sharding.py``'s plan):

- "mlstm": rank r computes heads r, whose features are ``d_inner``
  chunk r.  ``up_proj`` is column-parallel (its xm and z features r,
  the leaf's gate view); the conv, the skip and the head-wise norm are
  per feature; ``wq``, ``wk`` and ``wv`` are stored by rows (their second
  ``inner`` dim cannot also take ``model``), so each is row-parallel
  from the rank's features and its output reduce-scattered to heads r;
  ``w_if``'s rows likewise give a partial (B, S, 2H) that is summed over
  ``model``, of which the rank takes the i and f gates of heads r;
  ``down_proj`` is row-parallel, its output summed (Megatron's g).  The
  cache holds heads r: ``conv`` (the last K-1 pre-conv xm features r),
  ``C``, ``n``, ``m``.
- "slstm": rank r computes heads r.  ``w`` and ``b`` give the four gates
  of heads r (the leaves' gate view), ``r`` is block-diagonal by head,
  so the recurrence is local.  The cache holds heads r: ``c``, ``n``,
  ``h``, ``m``.
- "slstm_ffn": the sLSTM block's post-FFN, column- then row-parallel
  by its width, where that width divides ``model``; the new ``h`` of
  every head is then gathered over ``model`` for the post-norm, which
  needs the whole row.  Where "slstm" splits and the width does not,
  the post-norm runs on heads r (its mean square summed over
  ``model``), the up projection is row-parallel from them and summed
  over ``model``, and the down projection computes whole on every rank,
  as the reference's partitioner computes it.

Under the sequence split (``seq_shard``) both blocks gather the residual
stream's positions first and hand back the rank's positions of their
output (``sublayer_in`` / ``sublayer_out``): the recurrences run over the
whole sequence, and a prefill's states are the same.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (
    copy_to, gather_cols, reduce_from, reduce_scatter_cols, scatter_to,
    sum_over,
)
from repro_torch.distributed.sharding import (
    current_tp, seq_param, sublayer_in, sublayer_out,
)
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
        "up_proj": dense_init((d, 2 * di), ("embed", "inner")),
        "conv_w": dense_init((K, di), ("conv", "inner")),
        "conv_b": zeros_init((di,), ("inner",)),
        "wq": dense_init((di, di), ("inner", "inner")),
        "wk": dense_init((di, di), ("inner", "inner")),
        "wv": dense_init((di, di), ("inner", "inner")),
        "w_if": dense_init((di, 2 * H), ("inner", "heads")),
        "b_i": zeros_init((H,), ("heads",), dtype="float32"),
        "b_f": const_init((H,), ("heads",), 3.0, dtype="float32"),
        "skip": ones_init((di,), ("inner",)),
        "norm_scale": ones_init((di,), ("inner",)),
        "down_proj": dense_init((di, d), ("inner", "embed")),
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
    """x: (B,S,D).  cache: {"conv": (B,K-1,di), "C","n","m"}.  Under the
    tensor-parallel plan the leaves and the cache are the rank's heads
    (see the module doc)."""
    cdt = dtype_of(cfg.compute_dtype)
    H = cfg.n_heads
    dh = cfg.d_inner_mlstm // H
    tp = current_tp("mlstm")
    group = None if tp is None else tp.group
    di = params["up_proj"].shape[1] // 2        # this rank's features
    nh = di // dh                               # and heads
    x = sublayer_in(x.to(cdt), tp)
    B, S, D = x.shape

    xz = x @ params["up_proj"].to(cdt)
    xm, z = torch.chunk(xz, 2, dim=-1)

    conv_cache = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(
        xm, params["conv_w"].to(cdt), params["conv_b"].to(cdt), conv_cache)
    xc = F.silu(xc)

    def heads(a, w):
        # row-parallel over the rank's features; the rank keeps its heads
        return reduce_scatter_cols(a @ params[w].to(cdt),
                                   group).reshape(B, S, nh, dh)

    q, k, v = heads(xc, "wq"), heads(xc, "wk"), heads(xm, "wv")
    gates = (xm @ params["w_if"].to(cdt)).float()
    # (B,S,2H) partials summed: every rank's heads read the sum
    gates = copy_to(reduce_from(gates, group), group)
    lo = 0 if tp is None else tp.rank * nh
    logi = gates[..., lo:lo + nh] + params["b_i"][None, None]
    logf = F.logsigmoid(gates[..., H + lo:H + lo + nh]
                        + params["b_f"][None, None])

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
    out = sublayer_out((h * F.silu(z)) @ params["down_proj"].to(cdt), tp)
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


def mlstm_cache_axes() -> dict:
    return {"conv": ("batch", "conv", "inner"),
            "C": ("batch", "heads", "head_dim", "head_dim"),
            "n": ("batch", "heads", "head_dim"),
            "m": ("batch", "heads")}


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
        "w": dense_init((d, 4 * d), ("embed", "inner")),
        # block-diagonal (per-head) recurrent weights for 4 gates
        "r": dense_init((4, H, dh, dh),
                        (None, "heads", "head_dim", "head_dim"),
                        dtype="float32", scale=0.05),
        "b": const_init((4 * d,), ("inner",), 0.0, 3.0, 0.0, 0.0,
                        dtype="float32"),
        "norm_scale": ones_init((d,), ("embed",)),
        "ffn_up": dense_init((d, hf), ("embed", "ffn")),
        "ffn_down": dense_init((hf, d), ("ffn", "embed")),
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
    """x: (B,S,D).  A Python loop over time (sLSTM is not parallelizable).
    Under the tensor-parallel plan the gates, the recurrence and the cache
    are the rank's heads (see the module doc)."""
    cdt = dtype_of(cfg.compute_dtype)
    tp = current_tp("slstm")
    group = None if tp is None else tp.group
    r = params["r"]
    nh = r.shape[1]                             # this rank's heads
    x = sublayer_in(x.to(cdt), tp)
    B, S, D = x.shape
    dh = D // cfg.n_heads

    wx = (x @ params["w"].to(cdt)).float()
    wx = (wx + params["b"][None, None]).reshape(B, S, 4, nh, dh)

    if cache is None:
        carry = _slstm_state(B, nh, dh, x.device)
        carry = (carry["c"], carry["n"], carry["h"], carry["m"])
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])

    hs = []
    for t in range(S):
        carry = _slstm_cell(carry, wx[:, t], r)
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).reshape(B, S, nh * dh).to(cdt)
    ffn = current_tp("slstm_ffn")
    if group is not None and ffn is None:
        # the post-FFN's width does not split: the post-norm of the rank's
        # heads, its statistics summed over model, and the up projection
        # row-parallel from them (the rows of the rank's heads), as the
        # reference's partitioner contracts over the split features
        out = _slstm_post_split(params, h, cfg, tp, D)
    else:
        h = gather_cols(h, group)       # the post-norm reads every head
        # post-norm + gelu FFN (sLSTM block's post up/down projection)
        hf = h.float()
        var = torch.mean(hf * hf, dim=-1, keepdim=True)
        hn = (hf * torch.rsqrt(var + 1e-6)
              * params["norm_scale"].float()).to(cdt)
        # jax.nn.gelu defaults to the tanh approximation
        up = copy_to(hn, None if ffn is None else ffn.group) \
            @ params["ffn_up"].to(cdt)
        out = sublayer_out(F.gelu(up, approximate="tanh")
                           @ params["ffn_down"].to(cdt), ffn)

    new_cache = None
    if cache is not None or return_state:
        new_cache = {"c": carry[0], "n": carry[1], "h": carry[2],
                     "m": carry[3]}
    return out, new_cache


def _slstm_post_split(params, h, cfg, tp, D: int):
    """The sLSTM block's post-norm and post-FFN on the rank's heads ``h``
    (B, S, D / m) where "slstm" splits and "slstm_ffn" does not: the
    norm's mean square summed over ``model``, the rank's features of the
    norm and its rows of ``ffn_up`` (their gradients gathered whole), the
    up projection summed over ``model`` (Megatron's g; under the sequence
    split reduce-scattered to the rank's positions, as the reference's
    partitioner leaves it), the down projection whole (under the sequence
    split on the rank's positions, its gradient summed over ``model``).
    Returns the block's output to the residual stream."""
    cdt = dtype_of(cfg.compute_dtype)
    group = tp.group
    hf = h.float()
    var = sum_over(torch.sum(hf * hf, dim=-1, keepdim=True), group) / D
    scale = scatter_to(params["norm_scale"], group, 0).float()
    hn = (hf * torch.rsqrt(var + 1e-6) * scale).to(cdt)
    up = sublayer_out(hn @ scatter_to(params["ffn_up"], group, 0).to(cdt),
                      tp)
    return F.gelu(up, approximate="tanh") @ seq_param(
        params["ffn_down"]).to(cdt)


def _slstm_state(batch: int, heads: int, dh: int, device) -> dict:
    shape = (batch, heads, dh)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full(shape, M_INIT, dtype=torch.float32,
                            device=device)}


def init_slstm_cache(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    """All four states are float32 (``dtype`` is taken for the signature
    that every mixer's cache shares).  Separate tensors: a prefill merge
    writes each one in place."""
    H = cfg.n_heads
    return _slstm_state(batch, H, cfg.d_model // H, device)


def slstm_cache_axes() -> dict:
    axes = ("batch", "heads", "head_dim")
    return {"c": axes, "n": axes, "h": axes, "m": axes}
