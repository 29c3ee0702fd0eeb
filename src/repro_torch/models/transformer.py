"""Decoder stack for the dense families: per-layer (mixer, ffn) blocks.

Counterpart of ``repro/models/transformer.py``.  ``n_layers`` is split
into ``n_groups`` repetitions of the config's layer ``pattern``, as in
the reference; the reference scans over the stacked group axis, the port
loops over an unrolled ``ModuleList`` (``groups.<i>.l<j>...``).

Mixers ``attn`` / ``attn_local`` / ``mlstm`` / ``slstm`` and ffn ``mlp``
are ported; ``mamba`` and ``moe`` raise ``NotImplementedError`` naming
their ROADMAP item.  Training: ``trunk`` and the sequence-chunked
``loss``, with the reference's ``remat`` policies as activation
checkpointing around each group.  Serving: ``prefill``, ``decode_step``
and ``init_cache``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig, Layer
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.params import ParamTree, dtype_of, resolve_device

_NOT_PORTED = {"mamba": "A9 (ssm)", "moe": "A9 (moe)"}


def _not_ported(kind: str):
    return NotImplementedError(
        f"{kind!r} layers are not ported to repro_torch yet "
        f"(ROADMAP {_NOT_PORTED.get(kind, '?')})")


def _zc(cfg) -> bool:
    # gemma-style (1 + w) zero-centered norm scaling
    return cfg.embed_scale


# ---------------------------------------------------------------------------
# One layer = norm -> mixer -> (+post-norm) -> residual -> norm -> ffn -> res
# ---------------------------------------------------------------------------


def init_layer(cfg: ArchConfig, layer: Layer) -> dict:
    p: dict = {"norm1": L.init_rmsnorm(cfg.d_model)}
    if layer.mixer in ("attn", "attn_local"):
        p["mixer"] = attn_mod.init_attn(cfg)
    elif layer.mixer == "mlstm":
        p["mixer"] = xlstm_mod.init_mlstm(cfg)
    elif layer.mixer == "slstm":
        p["mixer"] = xlstm_mod.init_slstm(cfg)
    else:
        raise _not_ported(layer.mixer)
    if cfg.post_norm:
        p["post_norm1"] = L.init_rmsnorm(cfg.d_model)
    if layer.ffn != "none":
        p["norm2"] = L.init_rmsnorm(cfg.d_model)
        if layer.ffn == "mlp":
            p["ffn"] = L.init_mlp(cfg)
        else:
            raise _not_ported(layer.ffn)
        if cfg.post_norm:
            p["post_norm2"] = L.init_rmsnorm(cfg.d_model)
    return p


def layer_apply(p, x, cfg: ArchConfig, layer: Layer, *, mode: str,
                positions=None, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None):
    """mode: train | prefill | decode.  Returns (x, new_cache, aux);
    new_cache is None in train mode, aux a dict of auxiliary losses (none
    for the ported mixers and ffns)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, zero_centered=_zc(cfg))
    mixer_cache = cache["mixer"] if mode == "decode" else None
    if layer.mixer in ("attn", "attn_local"):
        local = layer.mixer == "attn_local"
        if mode == "decode":
            h, new_mixer_cache = attn_mod.attn_apply(
                p["mixer"], h, cfg, local=local, cache=mixer_cache,
                cache_pos=cache_pos)
        else:
            h, new_mixer_cache = attn_mod.attn_apply(
                p["mixer"], h, cfg, local=local, positions=positions,
                return_kv=mode == "prefill")
    elif layer.mixer in ("mlstm", "slstm"):
        apply = (xlstm_mod.mlstm_apply if layer.mixer == "mlstm"
                 else xlstm_mod.slstm_apply)
        h, new_mixer_cache = apply(p["mixer"], h, cfg, cache=mixer_cache,
                                   return_state=mode == "prefill")
    else:
        raise _not_ported(layer.mixer)

    if cfg.post_norm:
        h = L.rmsnorm(p["post_norm1"], h, cfg.norm_eps, zero_centered=_zc(cfg))
    x = x + h

    if layer.ffn != "none":
        if layer.ffn != "mlp":
            raise _not_ported(layer.ffn)
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, zero_centered=_zc(cfg))
        h = L.mlp(p["ffn"], h, cfg)
        if cfg.post_norm:
            h = L.rmsnorm(p["post_norm2"], h, cfg.norm_eps,
                          zero_centered=_zc(cfg))
        x = x + h
    new_cache = None if mode == "train" else {"mixer": new_mixer_cache}
    return x, new_cache, {}


# ---------------------------------------------------------------------------
# Group = one repetition of the pattern
# ---------------------------------------------------------------------------


def init_group(cfg: ArchConfig) -> dict:
    return {f"l{i}": init_layer(cfg, layer)
            for i, layer in enumerate(cfg.pattern)}


def group_apply(gp, x, cfg: ArchConfig, *, mode, positions=None,
                gcache=None, cache_pos=None):
    """Returns (x, new caches or None, aux sum as a float32 scalar)."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}
    for i, layer in enumerate(cfg.pattern):
        cache_i = gcache[f"l{i}"] if gcache is not None else None
        x, nc, aux = layer_apply(
            gp[f"l{i}"], x, cfg, layer, mode=mode, positions=positions,
            cache=cache_i, cache_pos=cache_pos)
        if nc is not None:
            new_caches[f"l{i}"] = nc
        if "moe_aux" in aux:
            aux_sum = aux_sum + aux["moe_aux"]
    return x, (new_caches or None), aux_sum


# matmul results: what ``jax.checkpoint_policies.checkpoint_dots`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``cfg.remat``: none keeps every activation; full keeps only the
    group's inputs and recomputes the rest in the backward pass; dots
    keeps the matmul outputs too."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(cfg.remat)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model(ParamTree):
    """The parameter tree plus the training loss and prefill / decode.

    ``Model(cfg, device=...)`` allocates the parameters (in
    ``cfg.param_dtype``) without drawing them: call :meth:`init_params`
    with a ``torch.Generator``, or ``load_state_dict`` (for example from
    :func:`~repro_torch.models.params.from_jax_params`).  The device is
    ``cuda`` unless the caller names one.
    """

    def __init__(self, cfg: ArchConfig, *, device=None):
        device = resolve_device(device)
        super().__init__(
            {"embed": L.init_embed(cfg),
             "groups": [init_group(cfg) for _ in range(cfg.n_groups)],
             "final_norm": L.init_rmsnorm(cfg.d_model)},
            dtype_of(cfg.param_dtype), device)
        self.cfg = cfg
        self.device = device

    def _embed_inputs(self, inputs):
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            return L.embed(self.embed, inputs, cfg)
        x = inputs.to(dtype_of(cfg.compute_dtype))
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    # --- forward trunk ---------------------------------------------------

    def trunk(self, inputs, *, positions=None):
        """Embed + all blocks + final norm.  Returns (hidden, aux)."""
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def one_group(x, gp):
            out, _, a = group_apply(gp, x, cfg, mode="train",
                                    positions=positions)
            return out, a

        one_group = _remat(one_group, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp in self.groups:
            x, a = one_group(x, gp)
            aux = aux + a
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps,
                      zero_centered=_zc(cfg))
        return x, aux

    # --- training loss ----------------------------------------------------

    def loss(self, batch, *, seq_chunk: int = 512):
        """batch: {"inputs": (B,S) int or (B,S,D) float, "labels": (B,S)}.

        Cross-entropy over sequence chunks, each recomputed in the
        backward pass, so the full (B, S, vocab) logits never exist at
        once.  Returns (ce + 0.01 * aux, {"ce", "aux"}).
        """
        cfg = self.cfg
        x, aux = self.trunk(batch["inputs"])
        labels = batch["labels"].long()
        B, S = labels.shape
        w = (self.embed.embedding.T if cfg.tie_embeddings
             else self.embed.unembed).to(dtype_of(cfg.compute_dtype))

        n_chunks = max(1, S // seq_chunk)
        c = S // n_chunks
        xc = x.reshape(B, n_chunks, c, -1).transpose(0, 1)
        lc = labels.reshape(B, n_chunks, c).transpose(0, 1)

        def chunk_loss(x_i, l_i):
            # the reference's order: the product and the final softcap in
            # the compute dtype, then float32 for the log-sum-exp
            logits = x_i @ w
            if cfg.final_softcap:
                cap = cfg.final_softcap
                logits = cap * torch.tanh(logits / cap)
            logits = logits.float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, l_i[..., None])[..., 0]
            return torch.sum(lse - gold)

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for x_i, l_i in zip(xc, lc):
            total = total + checkpoint(chunk_loss, x_i, l_i,
                                       use_reentrant=False)
        ce = total / (B * S)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # --- serving ----------------------------------------------------------

    @torch.no_grad()
    def prefill(self, inputs):
        """Full-sequence forward; returns (last_logits, cache list).

        The cache holds one dict per group, in the decode layouts.
        """
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = []
        for gp in self.groups:
            x, c, _ = group_apply(gp, x, cfg, mode="prefill",
                                  positions=positions)
            caches.append(c)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps,
                      zero_centered=_zc(cfg))
        return L.logits(self.embed, x[:, -1:], cfg), caches

    @torch.no_grad()
    def decode_step(self, cache, inputs, pos: int):
        """inputs: (B,1) tokens or (B,1,D) embeds; pos: int.

        Writes position ``pos`` of the attention caches in place; the
        recurrent (xLSTM) states come back as new tensors.  Returns
        (logits, cache).
        """
        cfg = self.cfg
        x = self._embed_inputs(inputs)
        new_cache = []
        for gp, gc in zip(self.groups, cache):
            x, nc, _ = group_apply(gp, x, cfg, mode="decode", gcache=gc,
                                   cache_pos=pos)
            new_cache.append(nc)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps,
                      zero_centered=_zc(cfg))
        return L.logits(self.embed, x, cfg), new_cache

    # --- caches -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        cfg = self.cfg

        def layer_cache(layer: Layer):
            if layer.mixer in ("attn", "attn_local"):
                return {"mixer": attn_mod.init_attn_cache(
                    cfg, batch, max_len, dtype, self.device)}
            if layer.mixer == "mlstm":
                return {"mixer": xlstm_mod.init_mlstm_cache(
                    cfg, batch, dtype, self.device)}
            if layer.mixer == "slstm":
                return {"mixer": xlstm_mod.init_slstm_cache(
                    cfg, batch, dtype, self.device)}
            raise _not_ported(layer.mixer)

        return [{f"l{i}": layer_cache(layer)
                 for i, layer in enumerate(cfg.pattern)}
                for _ in range(cfg.n_groups)]
