"""Plain float32 reference of granite-moe-3b-a800m
(https://huggingface.co/ibm-granite/granite-3.0-3b-a800m-base) as the
configuration file states it: a pre-norm decoder layer of grouped-query
attention (24 query heads over 8 KV heads of 64, rotary embeddings, no
biases), then 40 SwiGLU experts of width 512, 8 per token, routed by a
softmax router with a capacity of int(1.25 * T * 8 / 40) pairs an expert
over the whole batch's T tokens; RMSNorm before each and after the last
layer; an untied output head; the loss adds 0.01 times the layers'
summed Switch load-balance terms.  (The published model's dropless
routing, tied embeddings and multipliers are not part of the
configuration the port runs: see the configuration file's
``departures`` and ``published``.)"""
from __future__ import annotations

from functools import partial

from reference import plain


def layer(w, g, x, pos, c, lp, past=None):
    """-> (x, this call's K and V (B, S, KV, hd), the layer's aux)."""
    p = f"groups.{g}.l0."
    eps = c["rms_norm_eps"]
    h = plain.rmsnorm(x, w[p + "norm1.scale"].float(), eps)
    a, k, v = plain.attention_block(w, p + "mixer.", h, pos, c, lp, past)
    x = x + a
    h = plain.rmsnorm(x, w[p + "norm2.scale"].float(), eps)
    ffn = p + "ffn."
    out, aux = plain.moe(
        h.reshape(-1, h.shape[-1]), w[ffn + "router"].float(),
        w[ffn + "w_gate"].float(), w[ffn + "w_up"].float(),
        w[ffn + "w_down"].float(), c["num_experts_per_tok"],
        c["capacity_factor"], lp)
    return x + out.view_as(x), k, v, aux


train_loss = partial(plain.train_loss, layer)
prefill = partial(plain.prefill, layer)
extend = partial(plain.extend, layer)
