"""Top-k routed mixture-of-experts with capacity-bounded scatter dispatch.

Counterpart of ``repro/models/moe.py``.  Dispatch is scatter/gather-based
(sorted-slot style), as in the reference: tokens are scattered into an
(experts, capacity, d_model) buffer, the experts run as batched matmuls
over that buffer, and their outputs are gathered back and combined with
the renormalised gate weights.

The arithmetic is the reference's: float32 router logits, ``-1e30`` for
padded (dead) experts, softmax, top-k, renormalised gates, and slot
positions in token-major order.  Three choices keep the card's result
deterministic and equal to the reference's:

- top-k is a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` orders them;
- slot positions come from a flat token-major cumsum, which equals the
  reference's grouped two-level cumsum (integer sums, exact);
- the dispatch scatter adds each kept (expert, slot) pair once and a
  dropped pair adds exact zeros, so its atomics are order-free; the
  combine sums each token's k contributions as a (T, k, D) view in the
  order j = 0..k-1, without atomics.

``moe_apply`` takes the dense route: the port has no mesh yet, and the
reference's expert-parallel route (``_moe_apply_ep``) comes with the
distribution slice (ROADMAP A11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.params import dense_init, dtype_of


def init_moe(cfg) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.padded_experts()
    p = {"router": dense_init((d, e)),
         "w_up": dense_init((e, d, f)),
         "w_down": dense_init((e, f, d))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((e, d, f))
    if m.shared_expert:
        p["shared_up"] = dense_init((d, f))
        p["shared_down"] = dense_init((f, d))
        if cfg.gated_mlp:
            p["shared_gate"] = dense_init((d, f))
    return p


def capacity_of(m, T: int) -> int:
    """Slots per expert for T tokens (reference ``moe.py:88``)."""
    return max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))


def route(router, xf, cfg):
    """Routing of the flat tokens ``xf`` (T, D).

    Returns ``probs`` (T, E) float32, ``gate_vals`` (T, k) renormalised,
    ``expert_ids`` (T, k), and per (token, choice) pair in token-major
    order: ``slot`` (T*k,), the pair's position in its expert's buffer,
    and ``keep`` (T*k,), whether that position is below the capacity.
    """
    m = cfg.moe
    T = xf.shape[0]
    k, E = m.top_k, m.padded_experts()
    logits = xf.float() @ router.float()
    if E > m.num_experts:
        # dead experts never win the top-k
        pad = torch.full((T, E - m.num_experts), -1e30, dtype=torch.float32,
                         device=xf.device)
        logits = torch.cat([logits[:, :m.num_experts], pad], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :k], ids[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_ids = expert_ids.reshape(T * k)
    onehot = F.one_hot(flat_ids, E)                       # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos, 1, flat_ids[:, None])[:, 0]
    keep = slot < capacity_of(m, T)
    return probs, gate_vals, expert_ids, slot, keep


def moe_apply(params, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), {"moe_aux", "moe_drop"})."""
    return _moe_apply_dense(params, x, cfg)


def _moe_apply_dense(params, x, cfg):
    m = cfg.moe
    cdt = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    T = B * S
    k, E = m.top_k, m.padded_experts()
    xf = x.reshape(T, D).to(cdt)

    probs, gate_vals, expert_ids, slot, keep = route(params["router"], xf,
                                                     cfg)
    flat_ids = expert_ids.reshape(T * k)
    safe_slot = torch.where(keep, slot, 0)
    token_idx = torch.arange(T * k, device=x.device) // k

    # scatter tokens into (E, C, D): each kept pair owns its slot
    contrib = torch.where(keep[:, None], xf[token_idx], 0)
    xe = torch.zeros((E, capacity_of(m, T), D), dtype=cdt,
                     device=x.device).index_put((flat_ids, safe_slot),
                                                contrib, accumulate=True)

    ye = L.mlp(params, xe, cfg)                                # (E, C, D)

    # gather back and combine, token by token in choice order
    weights = torch.where(keep, gate_vals.reshape(T * k), 0).to(cdt)
    parts = (ye[flat_ids, safe_slot] * weights[:, None]).view(T, k, D)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]

    if m.shared_expert:
        shared = {"w_up": params["shared_up"],
                  "w_down": params["shared_down"]}
        if cfg.gated_mlp:
            shared["w_gate"] = params["shared_gate"]
        out = out + L.mlp(shared, xf, cfg)

    # auxiliary load-balance loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    aux_loss = m.num_experts * torch.sum(me * ce)
    drop_frac = 1.0 - keep.float().mean()
    return out.reshape(B, S, D), {"moe_aux": aux_loss, "moe_drop": drop_frac}
