"""Decoder stack for the dense families: per-layer (mixer, ffn) blocks.

Counterpart of ``repro/models/transformer.py``.  ``n_layers`` is split
into ``n_groups`` repetitions of the config's layer ``pattern``, as in
the reference; the reference scans over the stacked group axis, the port
loops over an unrolled ``ModuleList`` (``groups.<i>.l<j>...``).

Mixers ``attn`` / ``attn_local`` / ``mlstm`` / ``slstm`` and ffn ``mlp``
are ported; ``mamba`` and ``moe`` raise ``NotImplementedError`` naming
their ROADMAP item.  Serving only: ``prefill``, ``decode_step`` and
``init_cache`` (training is ROADMAP A8).
"""
from __future__ import annotations

from typing import Optional

import torch

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
    """mode: prefill | decode.  Returns (x, new_cache)."""
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
    return x, {"mixer": new_mixer_cache}


# ---------------------------------------------------------------------------
# Group = one repetition of the pattern
# ---------------------------------------------------------------------------


def init_group(cfg: ArchConfig) -> dict:
    return {f"l{i}": init_layer(cfg, layer)
            for i, layer in enumerate(cfg.pattern)}


def group_apply(gp, x, cfg: ArchConfig, *, mode, positions=None,
                gcache=None, cache_pos=None):
    new_caches = {}
    for i, layer in enumerate(cfg.pattern):
        cache_i = gcache[f"l{i}"] if gcache is not None else None
        x, new_caches[f"l{i}"] = layer_apply(
            gp[f"l{i}"], x, cfg, layer, mode=mode, positions=positions,
            cache=cache_i, cache_pos=cache_pos)
    return x, new_caches


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model(ParamTree):
    """The parameter tree plus prefill / decode.

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
            x, c = group_apply(gp, x, cfg, mode="prefill",
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
            x, nc = group_apply(gp, x, cfg, mode="decode", gcache=gc,
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
