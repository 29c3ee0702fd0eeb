"""Public wrappers of the attention kernels, with the JAX signatures.

Counterpart of ``repro/kernels/ops.py``.  ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): its
forward is :func:`flash_attention_fwd` (the CUDA kernel on a CUDA tensor,
the plain version on the CPU), and its backward recomputes attention
through :func:`repro_torch.kernels.ref.attention` and differentiates that,
as the reference's ``_fa_bwd`` takes ``jax.vjp`` of ``ref.attention``.
The JAX package has no backward kernel; a hand-written one is ROADMAP B4.
``flash_decode`` is forward only, as in the reference.

A model takes these entries for a tensor :func:`on_card`: a CUDA
tensor, or inside :func:`card_program` a tensor of the device it names.
The dry run traces the card's program on fake meta tensors that way on
a host without CUDA (``analysis/program.py``).

The backward is the operator ``torch.ops.repro_torch.flash_attention_bwd``
(the same kernel on the CPU and on the card, its fake kernel on fake
tensors), so a trace on fake tensors (``analysis/program.py``) sees
it as one operator; its FLOP formula counts the recomputed forward's two
products and the backward's four, over every (query, key) pair.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    attention_flops, flash_attention_fwd,
)
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode


def _fa_bwd(q, k, v, g, scale, causal, window, softcap):
    """Grads of ``ref.attention`` at (q, k, v) against the upstream
    ``g``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.attention(*ins, scale=scale, causal=causal, window=window,
                            softcap=softcap)
        return torch.autograd.grad(out, ins, g)


def _bwd(*args):
    # ``_fa_bwd`` is looked up at each call: a profiler range can wrap it
    return _fa_bwd(*args)


def _bwd_fake(q, k, v, g, scale, causal, window, softcap):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


_ops = torch.library.Library("repro_torch", "FRAGMENT")
_ops.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor g, "
            "float scale, bool causal, int window, float softcap) "
            "-> (Tensor, Tensor, Tensor)")
_ops.impl("flash_attention_bwd", _bwd, "CPU")
_ops.impl("flash_attention_bwd", _bwd, "CUDA")
torch.library.register_fake("repro_torch::flash_attention_bwd", _bwd_fake,
                            lib=_ops)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 3 * attention_flops(q_shape, k_shape)


_CARD = {"cuda"}


def on_card(t) -> bool:
    """Whether ``t`` takes the kernels' path: a CUDA tensor, or a tensor
    of a device that :func:`card_program` names."""
    return t.device.type in _CARD


@contextlib.contextmanager
def card_program(device_type: str):
    """Send tensors of ``device_type`` down the card's path while it is
    open: fake ones (a real tensor of a device other than the CPU and the
    card raises in the kernels' entries)."""
    added = device_type not in _CARD
    _CARD.add(device_type)
    try:
        yield
    finally:
        if added:
            _CARD.discard(device_type)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (float(scale), bool(causal), int(window), float(softcap))
        return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = torch.ops.repro_torch.flash_attention_bwd(q, k, v, g,
                                                          *ctx.args)
        return (*(d if n else None for d, n in
                  zip(grads, ctx.needs_input_grad[:3])),
                None, None, None, None)


def flash_attention(q, k, v, scale, causal=True, window=0, softcap=0.0):
    """q: (B, S, NH, hd); k, v: (B, S, KV, hd) -> (B, S, NH, hd).

    Differentiable in q, k and v; scale, causal, window and softcap are
    constants."""
    return _FlashAttention.apply(q, k, v, scale, causal, window, softcap)


def flash_decode(q, k_cache, v_cache, pos, *, scale, window=0, softcap=0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd); pos int -> (B, NH, hd)."""
    return _flash_decode(q, k_cache, v_cache, pos, scale=scale,
                         window=window, softcap=softcap)
