"""Mamba-1 selective SSM block (jamba-style) with chunked scan.

Counterpart of ``repro/models/ssm.py``.  The selective scan is computed
chunk by chunk: a Python loop over sequence chunks (the reference's
``lax.scan``) carries the (B, d_inner, d_state) recurrent state, and
within a chunk a log-depth scan runs over the chunk dim.  The
materialized intermediate is (B, chunk, d_inner, d_state) float32 per
chunk, as in the reference.

The reference's ``jax.lax.associative_scan`` becomes a Hillis-Steele
scan over the same ``(a, b)`` pairs in float32: log2(chunk) doubling
steps, each one elementwise pass over the chunk, so the number of
kernels a chunk launches does not grow with its length (a sequential
loop would launch two per position).  Both compute the same recurrence
``h_t = a_t * h_{t-1} + b_t`` but associate its products differently,
so they round differently: the tests hold the port to the reference at
float32 atol = rtol = 2e-5.

The JAX package has no Pallas kernel for the scan, so this stays plain
PyTorch, as the reference's stays ``jnp``.  ``mamba_cache_axes`` comes
with the distribution slice (ROADMAP A11).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import (
    dense_init, dtype_of, log_arange_init, ones_init, zeros_init,
)


def init_mamba(cfg) -> dict:
    m = cfg.mamba
    d = cfg.d_model
    di = cfg.d_inner_mamba
    dtr = m.resolved_dt_rank(d)
    return {
        "in_proj": dense_init((d, 2 * di)),
        "conv_w": dense_init((m.d_conv, di)),
        "conv_b": zeros_init((di,)),
        "x_proj": dense_init((di, dtr + 2 * m.d_state)),
        "dt_proj": dense_init((dtr, di)),
        "dt_bias": zeros_init((di,)),
        # A initialized to -[1..N] per channel (S4D-real init)
        "A_log": log_arange_init((di, m.d_state), dtype="float32"),
        "D": ones_init((di,), dtype="float32"),
        "out_proj": dense_init((di, d)),
    }


def _causal_conv(x, w, b, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B,S,di), w: (K,di).  cache: (B,K-1,di).

    Returns (out, new_cache); new_cache is None without a cache, else the
    last K-1 inputs (cache included) in ``x``'s dtype.
    """
    K = w.shape[0]
    if cache is not None:
        x_pad = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = x_pad[:, -(K - 1):] if K > 1 else cache
    else:
        x_pad = F.pad(x, (0, 0, K - 1, 0))
        new_cache = None
    S = x.shape[1]
    out = sum(x_pad[:, i:i + S] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :], new_cache


def _scan_chunk(h0, a, bx):
    """Inclusive scan within a chunk.  h0: (B,di,N); a, bx: (B,Q,di,N).

    Returns every state of the chunk (B,Q,di,N) and the last (B,di,N).
    """
    Q = a.shape[1]
    d = 1
    while d < Q:
        # (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2), element i combined
        # with element i - d; the first d elements are already final
        a_new = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        a = a_new
        d *= 2
    h = a * h0[:, None] + bx
    return h, h[:, -1]


def selective_scan(x, dt, B_c, C_c, A, D, h0=None, chunk: int = 128):
    """x, dt: (B,S,di); B_c, C_c: (B,S,N); A: (di,N); D: (di,).

    Returns y (B,S,di) in ``x``'s dtype and the final state (B,di,N)
    float32.  S > chunk must be a multiple of chunk.
    """
    Bsz, S, di = x.shape
    N = A.shape[1]
    dtype = x.dtype
    x = x.float()
    dt = dt.float()
    B_c = B_c.float()
    C_c = C_c.float()

    a = torch.exp(dt[..., None] * A[None, None])             # (B,S,di,N)
    bx = (dt * x)[..., None] * B_c[:, :, None, :]             # (B,S,di,N)

    h = (torch.zeros((Bsz, di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    if S > chunk:
        assert S % chunk == 0, (S, chunk)
    ys = []
    for i in range(0, S, chunk):
        h_all, h = _scan_chunk(h, a[:, i:i + chunk], bx[:, i:i + chunk])
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, C_c[:, i:i + chunk]))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    y = y + x * D[None, None, :]
    return y.to(dtype), h


def mamba_apply(params, x, cfg, cache: Optional[dict] = None):
    """x: (B,S,D).  cache: {"conv": (B,K-1,di), "ssm": (B,di,N)}.

    Returns (out, new_cache); new_cache is None without a cache.  A
    prefill passes a fresh :func:`init_mamba_cache`, as the reference
    does, and gets the states after its last position back.
    """
    m = cfg.mamba
    cdt = dtype_of(cfg.compute_dtype)
    D = x.shape[-1]
    dtr = m.resolved_dt_rank(D)

    xz = x.to(cdt) @ params["in_proj"].to(cdt)                # (B,S,2di)
    xs, z = xz.chunk(2, dim=-1)

    conv_cache = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(
        xs, params["conv_w"].to(cdt), params["conv_b"].to(cdt), conv_cache)
    xs = F.silu(xs)

    bcd = xs @ params["x_proj"].to(cdt)                       # (B,S,dtr+2N)
    dt_r, B_c, C_c = torch.split(bcd, [dtr, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"].to(cdt)
                    + params["dt_bias"].to(cdt))              # (B,S,di)

    A = -torch.exp(params["A_log"])                           # (di,N) f32
    h0 = cache["ssm"] if cache is not None else None
    y, h_last = selective_scan(xs, dt, B_c, C_c, A, params["D"], h0=h0)

    out = (y * F.silu(z)) @ params["out_proj"].to(cdt)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": h_last}
    return out, new_cache


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, device=None):
    m = cfg.mamba
    di = cfg.d_inner_mamba
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                           device=device),
    }
