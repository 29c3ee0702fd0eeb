"""Public wrappers of the attention kernels, with the JAX signatures.

Counterpart of ``repro/kernels/ops.py``, forward only: the
``torch.autograd.Function`` whose backward recomputes through
:mod:`repro_torch.kernels.ref` comes with training (ROADMAP A8).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode


def flash_attention(q, k, v, scale, causal=True, window=0, softcap=0.0):
    """q: (B, S, NH, hd); k, v: (B, S, KV, hd) -> (B, S, NH, hd)."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               window=window, softcap=softcap)


def flash_decode(q, k_cache, v_cache, pos, *, scale, window=0, softcap=0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd); pos int -> (B, NH, hd)."""
    return _flash_decode(q, k_cache, v_cache, pos, scale=scale,
                         window=window, softcap=softcap)
