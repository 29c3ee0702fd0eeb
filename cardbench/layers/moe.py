"""moe: ``num_local_experts`` SwiGLU experts of width
``intermediate_size``, ``num_experts_per_tok`` a token, routed by a
softmax router with a capacity of ``capacity_factor`` (the port's
``models/moe.py``, without a shared expert).  The interface is
``benchlib.kinds``'."""
from benchlib import weights

ROLE = "ffn"


def leaves(c, p):
    D, F, E = (c["hidden_size"], c["intermediate_size"],
               c["num_local_experts"])
    return [weights.norm(p + "norm2.scale", D),
            weights.dense(p + "ffn.router", (D, E), D),
            weights.dense(p + "ffn.w_up", (E, D, F), D),
            weights.dense(p + "ffn.w_gate", (E, D, F), D),
            weights.dense(p + "ffn.w_down", (E, F, D), F)]


def check(c, arch):
    m = arch.moe
    if m is None:
        return {"experts": (None, c["num_local_experts"])}
    return {"experts": (m.num_experts, c["num_local_experts"]),
            "top_k": (m.top_k, c["num_experts_per_tok"]),
            "d_ff": (m.d_ff, c["intermediate_size"]),
            "capacity_factor": (m.capacity_factor, c["capacity_factor"]),
            "shared_expert": (m.shared_expert, False),
            "gated_mlp": (arch.gated_mlp, True)}


def matrix(c):
    """The router and the token's ``num_experts_per_tok`` experts."""
    D, F, E = (c["hidden_size"], c["intermediate_size"],
               c["num_local_experts"])
    return D * E + c["num_experts_per_tok"] * 3 * D * F


def params(c):
    D, F, E = (c["hidden_size"], c["intermediate_size"],
               c["num_local_experts"])
    return D * E + E * 3 * D * F + D


def launches(unit):
    return {}
