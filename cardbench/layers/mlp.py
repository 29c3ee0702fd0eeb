"""mlp: a SwiGLU feed-forward layer of width ``intermediate_size`` (the
port's gated ``models/layers.py`` ``mlp``).  The interface is
``benchlib.kinds``'."""
from benchlib import weights

ROLE = "ffn"


def leaves(c, p):
    D, F = c["hidden_size"], c["intermediate_size"]
    return [weights.norm(p + "norm2.scale", D),
            weights.dense(p + "ffn.w_up", (D, F), D),
            weights.dense(p + "ffn.w_gate", (D, F), D),
            weights.dense(p + "ffn.w_down", (F, D), F)]


def check(c, arch):
    return {"d_ff": (arch.d_ff, c["intermediate_size"]),
            "gated_mlp": (arch.gated_mlp, True)}


def matrix(c):
    return 3 * c["hidden_size"] * c["intermediate_size"]


def params(c):
    return matrix(c) + c["hidden_size"]


def launches(unit):
    return {}
