"""Public wrappers of the attention kernels, with the JAX signatures.

Counterpart of ``repro/kernels/ops.py``.  ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): its
forward is :func:`flash_attention_fwd` (the CUDA kernel on a CUDA tensor,
the plain version on the CPU), and its backward recomputes attention
through :func:`repro_torch.kernels.ref.attention` and differentiates that,
as the reference's ``_fa_bwd`` takes ``jax.vjp`` of ``ref.attention``.
The JAX package has no backward kernel; a hand-written one is ROADMAP B4.
``flash_decode`` is forward only, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode


def _fa_bwd(q, k, v, g, scale, causal, window, softcap, needs):
    """Grads of ``ref.attention`` at (q, k, v) against the upstream ``g``;
    None for an input whose ``needs`` flag is False."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = ref.attention(*ins, scale=scale, causal=causal, window=window,
                            softcap=softcap)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, want, g))
    return tuple(next(got) if n else None for n in needs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, window, softcap)
        return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _fa_bwd(q, k, v, g, *ctx.args,
                             needs=ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, scale, causal=True, window=0, softcap=0.0):
    """q: (B, S, NH, hd); k, v: (B, S, KV, hd) -> (B, S, NH, hd).

    Differentiable in q, k and v; scale, causal, window and softcap are
    constants."""
    return _FlashAttention.apply(q, k, v, scale, causal, window, softcap)


def flash_decode(q, k_cache, v_cache, pos, *, scale, window=0, softcap=0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd); pos int -> (B, NH, hd)."""
    return _flash_decode(q, k_cache, v_cache, pos, scale=scale,
                         window=window, softcap=softcap)
