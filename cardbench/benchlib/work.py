"""The work of a kernel call and of a whole step, from shapes alone, and
the card's peaks: the yardstick of the roofline and ``mfu`` metrics.

A call's least time is max(FLOPs / peak FLOP/s, bytes / peak bytes/s).
FLOPs count multiply-adds as two; bytes count each input read once and
each output written once.  Attention counts the (query, key) pairs that
causality (and a window) leaves: every product of a masked pair is work
a kernel need not do.  A step's FLOPs are the model's: the forward and
backward products without activation recompute; its bytes what the step
cannot avoid moving (the weights, and for a train step the gradients and
the optimizer state; for a decode step the cache read to its position).
"""
from __future__ import annotations

# published dense bf16 peaks and HBM bandwidth (NVIDIA's data sheet, SXM)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks(kind: str):
    return PEAKS.get(kind)


def least_s(flops: float, nbytes: float, pk: dict) -> float:
    return max(flops / pk["flops"], nbytes / pk["bytes_per_s"])


def causal_pairs(sq: int, sk: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask leaves when the sq queries are the
    last sq of sk positions (a window of w keeps w keys a query)."""
    first = sk - sq
    if not window:
        return sq * first + sq * (sq + 1) // 2
    return sum(min(first + i + 1, window) for i in range(sq))


def attention_call(q_shape, k_shape, *, causal=True, window=0,
                   itemsize=2):
    """flash_attention(q (B, S, H, hd), k and v (B, Sk, KV, hd)) ->
    (FLOPs, bytes): two products over the pairs; q, k, v read, out
    written."""
    B, S, H, hd = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    pairs = causal_pairs(S, Sk, window) if causal else S * Sk
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * Sk * KV * hd)
    return flops, nbytes


def decode_call(q_shape, k_shape, pos: int, *, window=0, q_itemsize=2,
                kv_itemsize=2):
    """flash_decode(q (B, H, hd), caches (B, S, KV, hd), pos) -> (FLOPs,
    bytes): keys 0 .. pos (the window's last ones) of each row and KV
    head read once; q read, out written."""
    B, H, hd = q_shape
    KV = k_shape[2]
    keys = min(pos + 1, window) if window else pos + 1
    flops = 4 * B * H * hd * keys
    nbytes = (2 * q_itemsize * B * H * hd +
              2 * kv_itemsize * B * KV * keys * hd)
    return flops, nbytes


# ---------------------------------------------------------------------------
# Whole steps of a configuration (c: a configs/*.json)
# ---------------------------------------------------------------------------


def _layer_params(c: dict) -> tuple[int, int]:
    """(matrix parameters a token passes through in one layer, all of the
    layer's parameters)."""
    D, H, KV, hd = (c["hidden_size"], c["num_attention_heads"],
                    c["num_key_value_heads"], c["head_dim"])
    F, E = c["intermediate_size"], c.get("num_local_experts", 0)
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    bias = (H + 2 * KV) * hd if c["attention_bias"] else 0
    if E:
        k = c["num_experts_per_tok"]
        return (attn + D * E + k * 3 * D * F,
                attn + bias + D * E + E * 3 * D * F + 2 * D)
    return attn + 3 * D * F, attn + bias + 3 * D * F + 2 * D


def n_params(c: dict) -> int:
    D, V = c["hidden_size"], c["vocab_size"]
    head = 0 if c["tie_word_embeddings"] else D * V
    return V * D + head + c["num_hidden_layers"] * _layer_params(c)[1] + D


def _attn_flops(c: dict, B: int, sq: int, sk: int) -> int:
    """Forward attention products of all layers: 4 H hd a pair."""
    return (4 * B * c["num_attention_heads"] * c["head_dim"] *
            causal_pairs(sq, sk) * c["num_hidden_layers"])


def train_step(c: dict, B: int, S: int) -> tuple[int, int]:
    """One optimizer step on B x S tokens: 6 FLOPs a matrix parameter a
    token (forward 2, backward 4) plus 3x the forward attention products;
    bytes: the bf16 weights read in the forward and the backward, the
    gradients written, and AdamW reading the weights, gradients and both
    float32 moments and writing the weights and moments."""
    D, V = c["hidden_size"], c["vocab_size"]
    per_token = c["num_hidden_layers"] * _layer_params(c)[0] + D * V
    flops = 6 * per_token * B * S + 3 * _attn_flops(c, B, S, S)
    w = 2 if c["param_dtype"] == "bfloat16" else 4
    o = 4 if c["opt_dtype"] == "float32" else 2
    P = n_params(c)
    nbytes = P * (2 * w + w + (w + w + 2 * o) + (w + 2 * o))
    return flops, nbytes


def prefill(c: dict, S: int) -> tuple[int, int]:
    """One prompt of S tokens: 2 FLOPs a matrix parameter a token, the
    forward attention products over the causal pairs, the head on the last
    position; bytes: the weights read once (the embedding's S rows), the
    K and V cache written."""
    D, V = c["hidden_size"], c["vocab_size"]
    L, KV, hd = c["num_hidden_layers"], c["num_key_value_heads"], \
        c["head_dim"]
    flops = (2 * L * _layer_params(c)[0] * S + _attn_flops(c, 1, S, S) +
             2 * D * V)
    it = 2 if c["param_dtype"] == "bfloat16" else 4
    cache_it = 2 if c["cache_dtype"] == "bfloat16" else 4
    nbytes = (it * (n_params(c) - V * D + S * D) +
              cache_it * 2 * L * KV * hd * S)
    return flops, nbytes


def decode_step(c: dict, B: int, pos: int) -> tuple[int, int]:
    """One token for each of B rows at position ``pos``: 2 FLOPs a matrix
    parameter and the head a row, attention over keys 0 .. pos; bytes: the
    weights read once (the embedding's B rows) and each row's cache read
    to ``pos``."""
    D, V = c["hidden_size"], c["vocab_size"]
    L, KV, hd = c["num_hidden_layers"], c["num_key_value_heads"], \
        c["head_dim"]
    flops = (2 * B * (L * _layer_params(c)[0] + D * V) +
             _attn_flops(c, B, 1, pos + 1))
    it = 2 if c["param_dtype"] == "bfloat16" else 4
    cache_it = 2 if c["cache_dtype"] == "bfloat16" else 4
    nbytes = (it * (n_params(c) - V * D + B * D) +
              cache_it * 2 * L * B * KV * hd * (pos + 1))
    return flops, nbytes
