"""Plain float32 reference of qwen2-7b (arXiv:2407.10671;
https://huggingface.co/Qwen/Qwen2-7B): a pre-norm decoder layer of
grouped-query attention with biased q, k and v projections and rotary
embeddings (theta 1e6), then a SwiGLU feed-forward layer; RMSNorm before
each and after the last layer; an untied output head."""
from __future__ import annotations

from functools import partial

from reference import plain


def layer(w, g, x, pos, c, lp, past=None):
    """-> (x, this call's K and V (B, S, KV, hd), aux 0)."""
    p = f"groups.{g}.l0."
    eps = c["rms_norm_eps"]
    h = plain.rmsnorm(x, w[p + "norm1.scale"].float(), eps)
    a, k, v = plain.attention_block(w, p + "mixer.", h, pos, c, lp, past)
    x = x + a
    h = plain.rmsnorm(x, w[p + "norm2.scale"].float(), eps)
    ffn = p + "ffn."
    x = x + plain.in_rows(lambda t: plain.swiglu(
        t, w[ffn + "w_gate"].float(), w[ffn + "w_up"].float(),
        w[ffn + "w_down"].float(), lp), h)
    return x, k, v, 0.0


train_loss = partial(plain.train_loss, layer)
prefill = partial(plain.prefill, layer)
extend = partial(plain.extend, layer)
