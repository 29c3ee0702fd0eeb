"""Core layers: RMSNorm, (gated) MLP, embeddings, logit head.

Counterpart of ``repro/models/layers.py``.  ``init_*`` return specs of
leaves (:class:`~repro_torch.models.params.Init`); the apply functions
take a parameter node (module or dict of tensors) and run in the
config's compute dtype, with float32 normalisation math.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import (
    dense_init, dtype_of, embed_init, ones_init,
)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int) -> dict:
    return {"scale": ones_init((d,))}


def rmsnorm(params, x, eps: float, *, zero_centered: bool = False):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if zero_centered:  # gemma-style (1 + w) scaling
        scale = 1.0 + scale
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------


def init_mlp(cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": dense_init((d, f)), "w_down": dense_init((f, d))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((d, f))
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(params, x, cfg):
    cdt = dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    up = x @ params["w_up"].to(cdt)
    if cfg.gated_mlp:
        h = _act(cfg.act)(x @ params["w_gate"].to(cdt)) * up
    else:
        h = _act(cfg.act)(up)
    return h @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / logit head
# ---------------------------------------------------------------------------


def init_embed(cfg) -> dict:
    p = {"embedding": embed_init((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size))
    return p


def embed(params, tokens, cfg):
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embedding"][tokens].to(cdt)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as in the
        # reference (jnp.asarray(d ** 0.5, cdt))
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    return x


def logits(params, x, cfg):
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = params["embedding"].to(cdt).T
    else:
        w = params["unembed"].to(cdt)
    out = x.to(cdt) @ w
    if cfg.final_softcap:
        cap = cfg.final_softcap
        out = cap * torch.tanh(out / cap)
    return out
