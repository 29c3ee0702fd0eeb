"""attn: grouped-query attention with rotary embeddings, causal over every
earlier position (the port's ``models/attention.py``): q, k, v and out
projections (q, k, v biased where ``attention_bias``); its decode state
is the K and V cache.  The interface is ``benchlib.kinds``'."""
from benchlib import weights, work

ROLE = "mixer"
CHECK = "kv_err"
# a decode step writes K and V at its own position
CARRIED = ()


def _sizes(c):
    return (c["hidden_size"], c["num_attention_heads"],
            c["num_key_value_heads"], c["head_dim"])


def leaves(c, p):
    D, H, KV, hd = _sizes(c)
    out = [weights.norm(p + "norm1.scale", D),
           weights.dense(p + "mixer.wq", (D, H * hd), D),
           weights.dense(p + "mixer.wk", (D, KV * hd), D),
           weights.dense(p + "mixer.wv", (D, KV * hd), D),
           weights.dense(p + "mixer.wo", (H * hd, D), H * hd)]
    if c["attention_bias"]:
        out += [weights.Leaf(p + "mixer.bq", (H * hd,), 0.0, 0.1),
                weights.Leaf(p + "mixer.bk", (KV * hd,), 0.0, 0.1),
                weights.Leaf(p + "mixer.bv", (KV * hd,), 0.0, 0.1)]
    return out


def check(c, arch):
    return {"n_heads": (arch.n_heads, c["num_attention_heads"]),
            "n_kv_heads": (arch.n_kv_heads, c["num_key_value_heads"]),
            "head_dim_": (arch.head_dim_, c["head_dim"]),
            "rope_theta": (arch.rope_theta, c["rope_theta"]),
            "qkv_bias": (arch.qkv_bias, c["attention_bias"])}


def matrix(c):
    D, H, KV, hd = _sizes(c)
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def params(c):
    D, H, KV, hd = _sizes(c)
    bias = (H + 2 * KV) * hd if c["attention_bias"] else 0
    return matrix(c) + bias + D


def launches(unit):
    return {"flash_decode": 1} if unit == "decode" else \
        {"flash_attention": 1}


def flops(c, B, sq, sk):
    """The two products over the (query, key) pairs causality leaves."""
    _, H, _, hd = _sizes(c)
    return 4 * B * H * hd * work.causal_pairs(sq, sk)


def _kv_bytes(c, positions):
    _, _, KV, hd = _sizes(c)
    return weights.DTYPES[c["cache_dtype"]].itemsize * 2 * KV * hd * \
        positions


def state_read(c, B, pos):
    """Each row's K and V at keys 0 .. pos."""
    return _kv_bytes(c, B * (pos + 1))


def state_written(c, S):
    return _kv_bytes(c, S)


def history(c, seed, layer, B, length, device):
    """K (B, KV, hd, S) and V (B, KV, S, hd), the port's decode layouts,
    N(0, 1) in ``cache_dtype``."""
    _, _, KV, hd = _sizes(c)
    return {"k": weights.normal((B, KV, hd, length), c["cache_dtype"], seed,
                                (2, layer, 0), device),
            "v": weights.normal((B, KV, length, hd), c["cache_dtype"], seed,
                                (2, layer, 1), device)}


def port_prefill(state, P):
    """A prefill's cache (one row) at positions P: (P, KV, hd) each."""
    return {"k": state["k"][0][:, :, P].permute(2, 0, 1),
            "v": state["v"][0][:, P].permute(1, 0, 2)}


def ref_prefill(state, P):
    """The reference layer's K and V (1, S, KV, hd) at positions P."""
    return {"k": state["k"][0, P], "v": state["v"][0, P]}


def port_decode(state, rows, new):
    """The rows' K and V at the positions ``new``: (R, T, KV, hd) each."""
    return {"k": state["k"][rows][..., new].permute(0, 3, 1, 2),
            "v": state["v"][rows][:, :, new].permute(0, 2, 1, 3)}


def ref_history(state, rows, start):
    """The rows' first ``start`` positions, (R, start, KV, hd) float32."""
    return {"k": state["k"][rows].permute(0, 3, 1, 2)[:, :start].float(),
            "v": state["v"][rows].permute(0, 2, 1, 3)[:, :start].float()}
