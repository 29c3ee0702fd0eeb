"""The benchmark's weights and its decode history, made from the seed.

Both sides get the same tensors: the program has them bound as its
parameters (``port.bind_model``) and the reference makes them again from
the seed after the window.  The layout is the benchmark's own, written
from the configuration file: one leaf per weight, named as the port's
``state_dict`` names it (``port.bind_model`` holds the port's model to
it).  Every weight is drawn in one call into one flat buffer on the
device, in the dtype it is served in, and each leaf is a view of it:

- a matrix is N(0, 1) / sqrt(fan_in), fan_in the dimension its product
  contracts (an expert's ``w_down`` contracts its ``d_ff``);
- the embedding is N(0, 1) * 0.02;
- a norm's scale is 1 + 0.1 * N(0, 1) and a bias 0.1 * N(0, 1), so
  that the reference cannot pass by leaving either out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def seed_of(seed: int, *stream) -> int:
    """A 63-bit seed for the stream ``stream`` of the run seed ``seed``
    (any whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 63, *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 63, *stream]))


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    mean: float
    std: float


def leaf_specs(c: dict) -> list[Leaf]:
    """Every weight of the configuration ``c`` (a ``configs/*.json``)."""
    D, V = c["hidden_size"], c["vocab_size"]
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    F = c["intermediate_size"]
    E = c.get("num_local_experts", 0)

    def dense(name, shape, fan_in):
        return Leaf(name, tuple(shape), 0.0, 1.0 / math.sqrt(fan_in))

    leaves = [Leaf("embed.embedding", (V, D), 0.0, 0.02)]
    if not c["tie_word_embeddings"]:
        leaves.append(dense("embed.unembed", (D, V), D))
    for g in range(c["num_hidden_layers"]):
        p = f"groups.{g}.l0."
        leaves += [Leaf(p + "norm1.scale", (D,), 1.0, 0.1),
                   dense(p + "mixer.wq", (D, H * hd), D),
                   dense(p + "mixer.wk", (D, KV * hd), D),
                   dense(p + "mixer.wv", (D, KV * hd), D),
                   dense(p + "mixer.wo", (H * hd, D), H * hd)]
        if c["attention_bias"]:
            leaves += [Leaf(p + "mixer.bq", (H * hd,), 0.0, 0.1),
                       Leaf(p + "mixer.bk", (KV * hd,), 0.0, 0.1),
                       Leaf(p + "mixer.bv", (KV * hd,), 0.0, 0.1)]
        leaves.append(Leaf(p + "norm2.scale", (D,), 1.0, 0.1))
        if E:
            leaves += [dense(p + "ffn.router", (D, E), D),
                       dense(p + "ffn.w_up", (E, D, F), D),
                       dense(p + "ffn.w_gate", (E, D, F), D),
                       dense(p + "ffn.w_down", (E, F, D), F)]
        else:
            leaves += [dense(p + "ffn.w_up", (D, F), D),
                       dense(p + "ffn.w_gate", (D, F), D),
                       dense(p + "ffn.w_down", (F, D), F)]
    leaves.append(Leaf("final_norm.scale", (D,), 1.0, 0.1))
    return leaves


def make(c: dict, seed: int, device) -> dict:
    """The weights of ``c`` for ``seed``: {name: view of one flat buffer}
    in ``c["param_dtype"]`` on ``device``."""
    specs = leaf_specs(c)
    dtype = DTYPES[c["param_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1))
    flat = torch.empty(sum(math.prod(s.shape) for s in specs), dtype=dtype,
                       device=device)
    flat.normal_(generator=gen)
    views, off = {}, 0
    for s in specs:
        n = math.prod(s.shape)
        views[s.name] = flat[off:off + n].view(s.shape)
        off += n
    with torch.no_grad():
        torch._foreach_mul_(list(views.values()), [s.std for s in specs])
        shifted = [views[s.name] for s in specs if s.mean]
        if shifted:
            torch._foreach_add_(shifted, 1.0)
    return views


# ---------------------------------------------------------------------------
# The decode history: a bf16 KV cache drawn from the seed
# ---------------------------------------------------------------------------


def history_layer(c: dict, seed: int, layer: int, kind: str, batch: int,
                  length: int, device) -> torch.Tensor:
    """Layer ``layer``'s K (``kind`` "k": (B, KV, hd, S)) or V ("v":
    (B, KV, S, hd)) cache, N(0, 1) in ``c["cache_dtype"]``: the port's
    decode layouts (the values are the benchmark's)."""
    KV, hd = c["num_key_value_heads"], c["head_dim"]
    shape = ((batch, KV, hd, length) if kind == "k"
             else (batch, KV, length, hd))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 2, layer, 0 if kind == "k" else 1))
    t = torch.empty(shape, dtype=DTYPES[c["cache_dtype"]], device=device)
    return t.normal_(generator=gen)
