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

from benchlib import kinds

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
# Whole steps of a configuration (c: a configs/*.json), summed over its
# layers' kinds (benchlib.kinds)
# ---------------------------------------------------------------------------


def _kinds(c: dict) -> list:
    """The kind of every sublayer of ``c``, mixers and ffns."""
    return [k for layer in kinds.layers(c) for k in layer.kinds]


def _mixers(c: dict) -> list:
    return [layer.mixer for layer in kinds.layers(c)]


def n_params(c: dict) -> int:
    D, V = c["hidden_size"], c["vocab_size"]
    head = 0 if c["tie_word_embeddings"] else D * V
    return V * D + head + sum(k.params(c) for k in _kinds(c)) + D


def _matrix(c: dict) -> int:
    """The matrix parameters a token passes through in all layers."""
    return sum(k.matrix(c) for k in _kinds(c))


def _mixer_flops(c: dict, B: int, sq: int, sk: int) -> int:
    """The mixers' forward FLOPs beyond the products (attention's: 4 H hd
    a causal pair)."""
    return sum(k.flops(c, B, sq, sk) for k in _mixers(c))


def train_step(c: dict, B: int, S: int) -> tuple[int, int]:
    """One optimizer step on B x S tokens: 6 FLOPs a matrix parameter a
    token (forward 2, backward 4) plus 3x the mixers' forward FLOPs beyond
    the products; bytes: the bf16 weights read in the forward and the
    backward, the gradients written, and AdamW reading the weights,
    gradients and both float32 moments and writing the weights and
    moments."""
    D, V = c["hidden_size"], c["vocab_size"]
    per_token = _matrix(c) + D * V
    flops = 6 * per_token * B * S + 3 * _mixer_flops(c, B, S, S)
    w = 2 if c["param_dtype"] == "bfloat16" else 4
    o = 4 if c["opt_dtype"] == "float32" else 2
    P = n_params(c)
    nbytes = P * (2 * w + w + (w + w + 2 * o) + (w + 2 * o))
    return flops, nbytes


def prefill(c: dict, S: int) -> tuple[int, int]:
    """One prompt of S tokens: 2 FLOPs a matrix parameter a token, the
    mixers' forward FLOPs beyond the products (attention's over the causal
    pairs), the head on the last position; bytes: the weights read once
    (the embedding's S rows), the mixers' decode state written (K and V
    of every position)."""
    D, V = c["hidden_size"], c["vocab_size"]
    flops = 2 * _matrix(c) * S + _mixer_flops(c, 1, S, S) + 2 * D * V
    it = 2 if c["param_dtype"] == "bfloat16" else 4
    nbytes = (it * (n_params(c) - V * D + S * D) +
              sum(k.state_written(c, S) for k in _mixers(c)))
    return flops, nbytes


def decode_step(c: dict, B: int, pos: int) -> tuple[int, int]:
    """One token for each of B rows at position ``pos``: 2 FLOPs a matrix
    parameter and the head a row, the mixers' FLOPs beyond the products
    (attention over keys 0 .. pos); bytes: the weights read once (the
    embedding's B rows) and the mixers' decode state read (each row's
    cache to ``pos``)."""
    D, V = c["hidden_size"], c["vocab_size"]
    flops = (2 * B * (_matrix(c) + D * V) +
             _mixer_flops(c, B, 1, pos + 1))
    it = 2 if c["param_dtype"] == "bfloat16" else 4
    nbytes = (it * (n_params(c) - V * D + B * D) +
              sum(k.state_read(c, B, pos) for k in _mixers(c)))
    return flops, nbytes
