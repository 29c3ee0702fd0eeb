"""Core layers: RMSNorm, (gated) MLP, embeddings, logit head.

Counterpart of ``repro/models/layers.py``.  ``init_*`` return specs of
leaves (:class:`~repro_torch.models.params.Init`); the apply functions
take a parameter node (module or dict of tensors) and run in the
config's compute dtype, with float32 normalisation math.

Under the mesh step's tensor-parallel plan (``distributed.sharding``)
the MLP and the embedding compute on this rank's chunk of their leaves:
f before a column-parallel product, g after a row-parallel one or after
the masked lookup of the rank's vocabulary rows
(``distributed.collectives``); under the sequence split (``seq_shard``)
the sequence all-gather and reduce-scatter in their place, and a whole
embedding keeps the rank's positions (``sublayer_in``,
``sublayer_out``).  The logit head computes the rank's vocabulary
columns and gathers them over ``model`` (serving).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import gathered
from repro_torch.distributed.sharding import (
    current_tp, sublayer_in, sublayer_out,
)
from repro_torch.models.params import (
    dense_init, dtype_of, embed_init, ones_init,
)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int) -> dict:
    return {"scale": ones_init((d,), ("embed",))}


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
    p = {"w_up": dense_init((d, f), ("embed", "ffn")),
         "w_down": dense_init((f, d), ("ffn", "embed"))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((d, f), ("embed", "ffn"))
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(params, x, cfg, tp=None):
    """A sublayer on the residual stream ``x`` (B, S, D).  With ``tp`` (a
    ``TPRank``: the leaves are this rank's ``d_ff`` columns of
    ``w_up``/``w_gate`` and rows of ``w_down``) the output is summed over
    the ranks (see ``sublayer_in`` / ``sublayer_out``)."""
    cdt = dtype_of(cfg.compute_dtype)
    out = ffn(params, sublayer_in(x.to(cdt), tp), cfg)
    return sublayer_out(out, tp)


def ffn(params, x, cfg):
    """The (gated) MLP's products on ``x`` (..., D), with no collective:
    the MoE experts run it on their slot buffers."""
    cdt = dtype_of(cfg.compute_dtype)
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
    p = {"embedding": embed_init((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"))
    return p


def embed(params, tokens, cfg):
    cdt = dtype_of(cfg.compute_dtype)
    table = params["embedding"]
    tp = current_tp("vocab")
    if tp is None:
        x = table[tokens]
    else:
        # this rank's vocabulary rows: other ranks' tokens read zeros, and
        # the sum over the ranks holds each token's row once
        ids = tokens - tp.rank * table.shape[0]
        mine = (ids >= 0) & (ids < table.shape[0])
        x = torch.where(
            mine[..., None], table[ids.clamp(0, table.shape[0] - 1)], 0)
    x = sublayer_out(x, tp).to(cdt)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as in the
        # reference (jnp.asarray(d ** 0.5, cdt))
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    return x


def logits(params, x, cfg):
    """Under a plan that splits the vocabulary the head holds this rank's
    columns, and the logits are gathered whole over ``model``."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = params["embedding"].to(cdt).T
    else:
        w = params["unembed"].to(cdt)
    out = x.to(cdt) @ w
    if cfg.final_softcap:
        cap = cfg.final_softcap
        out = cap * torch.tanh(out / cap)
    tp = current_tp("vocab")
    return out if tp is None else gathered(out, tp.group, out.dim() - 1)
