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

Under a mesh (``distributed.sharding.activation_sharding``, set by the
mesh train step, in which each rank holds only its own rows of the batch)
``moe_apply`` dispatches as the reference does:

- ``cfg.moe.ep_shard`` and ``_ep_applicable``: the expert-parallel route
  (the reference's ``shard_map`` region).  Each ``model`` rank holds the
  leaves of its E/m experts and its router columns, routes its own tokens
  over all experts (logits all-gathered over ``model``), computes its own
  experts at a *local* capacity, and the partial outputs are summed over
  ``model``.  ``aux`` and ``drop`` are averaged over the batch axes;
- otherwise the dense route over the whole (micro)batch, as XLA computes
  it: the rows are all-gathered over the batch axes, every rank routes and
  computes all tokens, and keeps its own rows.

The collectives are the autograd functions of
``distributed/collectives.py``: Megatron's f and g over ``model``, and
the row all-gather (its gradient a reduce-scatter sum) and the mean over
the batch axes.  A group of one rank skips its collective.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.collectives import (
    _CopyTo, _GatherCols, _GatherRows, _MeanOver, _ReduceFrom,
)
from repro_torch.distributed.sharding import (
    axis_groups, current_mesh, current_rules,
)
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import layers as L
from repro_torch.models.params import dense_init, dtype_of


def init_moe(cfg) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.padded_experts()
    p = {"router": dense_init((d, e), ("embed", "expert")),
         "w_up": dense_init((e, d, f), ("expert", "embed", "expert_ffn")),
         "w_down": dense_init((e, f, d), ("expert", "expert_ffn", "embed"))}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init((e, d, f),
                                 ("expert", "embed", "expert_ffn"))
    if m.shared_expert:
        p["shared_up"] = dense_init((d, f), ("embed", "ffn"))
        p["shared_down"] = dense_init((f, d), ("ffn", "embed"))
        if cfg.gated_mlp:
            p["shared_gate"] = dense_init((d, f), ("embed", "ffn"))
    return p


def capacity_of(m, T: int) -> int:
    """Slots per expert for T tokens (reference ``moe.py:88``)."""
    return max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))


def route(router, xf, cfg, group=None):
    """Routing of the flat tokens ``xf`` (T, D).

    Returns ``probs`` (T, E) float32, ``gate_vals`` (T, k) renormalised,
    ``expert_ids`` (T, k), and per (token, choice) pair in token-major
    order: ``slot`` (T*k,), the pair's position in its expert's buffer,
    and ``keep`` (T*k,), whether that position is below the capacity.
    With ``group`` (the expert-parallel route) ``router`` holds this
    rank's columns, and the logits are gathered over the group.
    """
    m = cfg.moe
    T = xf.shape[0]
    k, E = m.top_k, m.padded_experts()
    logits = xf.float() @ router.float()
    if group is not None:
        logits = _GatherCols.apply(logits, group)
    if E > m.num_experts:
        # dead experts never win the top-k
        col = torch.arange(E, device=xf.device)[None, :]
        logits = torch.where(col < m.num_experts, logits, -1e30)
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


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def moe_apply(params, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), {"moe_aux", "moe_drop"})."""
    mesh = current_mesh()
    if mesh is not None:
        if cfg.moe.ep_shard and _ep_applicable(cfg, x, mesh):
            return _moe_apply_ep(params, x, cfg, mesh)
        groups = axis_groups(mesh, current_rules()["act_tokens"])
        if groups:
            return _moe_apply_gathered(params, x, cfg, groups)
    return _moe_apply_dense(params, x, cfg)


def _experts(params, xin, cfg, gate_vals, expert_ids, slot, keep, *,
             lo: int = 0, group=None):
    """Scatter the kept (token, choice) pairs of experts ``lo ..
    lo + E_l - 1`` (the expert leaves' rows) into their slots, run the
    experts, and combine each token's k contributions in choice order.
    With ``group`` (expert parallel), pairs of other ranks' experts are
    left out and the partial outputs are summed over the group."""
    cdt = dtype_of(cfg.compute_dtype)
    T, D = xin.shape
    k = cfg.moe.top_k
    E_l = params["w_up"].shape[0]
    ids = expert_ids.reshape(T * k)
    if group is not None:
        keep = keep & (ids >= lo) & (ids < lo + E_l)
        ids = torch.where(keep, ids - lo, 0)
    safe_slot = torch.where(keep, slot, 0)
    token_idx = torch.arange(T * k, device=xin.device) // k

    # scatter tokens into (E_l, C, D): each kept pair owns its slot
    contrib = torch.where(keep[:, None], xin[token_idx], 0)
    xe = torch.zeros((E_l, capacity_of(cfg.moe, T), D), dtype=cdt,
                     device=xin.device).index_put((ids, safe_slot), contrib,
                                                  accumulate=True)
    ye = L.mlp(params, xe, cfg)                               # (E_l, C, D)

    # gather back and combine, token by token in choice order
    gates = gate_vals.reshape(T * k)
    if group is not None:
        gates = _CopyTo.apply(gates, group)
    weights = torch.where(keep, gates, 0).to(cdt)
    parts = (ye[ids, safe_slot] * weights[:, None]).view(T, k, D)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out if group is None else _ReduceFrom.apply(out, group)


def _shared(params, xf, cfg):
    shared = {"w_up": params["shared_up"], "w_down": params["shared_down"]}
    if cfg.gated_mlp:
        shared["w_gate"] = params["shared_gate"]
    return L.mlp(shared, xf, cfg)


def _aux(probs, expert_ids, keep, m):
    """Switch-style load-balance loss and the dropped share of the pairs."""
    me = probs.mean(0)
    ce = F.one_hot(expert_ids[:, 0], probs.shape[1]).float().mean(0)
    return m.num_experts * torch.sum(me * ce), 1.0 - keep.float().mean()


def _moe_apply_dense(params, x, cfg):
    m = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(B * S, D).to(dtype_of(cfg.compute_dtype))
    probs, gate_vals, expert_ids, slot, keep = route(params["router"], xf,
                                                     cfg)
    out = _experts(params, xf, cfg, gate_vals, expert_ids, slot, keep)
    if m.shared_expert:
        out = out + _shared(params, xf, cfg)
    aux, drop = _aux(probs, expert_ids, keep, m)
    return out.reshape(B, S, D), {"moe_aux": aux, "moe_drop": drop}


def _moe_apply_gathered(params, x, cfg, groups):
    """The dense route over the rows of every rank of ``groups`` (the
    batch axes, in mesh order): returns this rank's rows of it."""
    idx = 0
    for group in groups:
        idx = idx * dist.get_world_size(group) + dist.get_rank(group)
    x_all = x
    for group in reversed(groups):          # the minor axis first
        x_all = _GatherRows.apply(x_all, group)
    out, aux = _moe_apply_dense(params, x_all, cfg)
    return out[idx * x.shape[0]:(idx + 1) * x.shape[0]], aux


def _ep_applicable(cfg, x, mesh) -> bool:
    """The reference's test (``moe.py:165``) on the batch it sees: ``x``
    holds this rank's rows, split over the context's batch axes."""
    m = cfg.moe
    sizes = mesh_axis_sizes(mesh)
    if "model" not in sizes:
        return False
    dp_size = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    E = m.padded_experts()
    B = x.shape[0] * math.prod(sizes[a] for a in
                               current_rules().get("act_batch", ()))
    T = B * x.shape[1]
    return (E % sizes["model"] == 0
            and B % dp_size == 0
            and (T // dp_size) * m.top_k >= 4 * E)   # enough local tokens


def _moe_apply_ep(params, x, cfg, mesh):
    """Expert parallelism over ``model`` (the reference's ``_moe_apply_ep``):
    the expert leaves and router columns are this rank's; capacity counts
    this rank's tokens."""
    m = cfg.moe
    n_model = mesh_axis_sizes(mesh)["model"]
    E_l = params["w_up"].shape[0]
    if E_l * n_model != m.padded_experts():
        raise ValueError(f"the expert-parallel route takes this rank's "
                         f"{m.padded_experts() // n_model} experts, got "
                         f"{E_l}")
    group = mesh.get_group("model") if n_model > 1 else None
    B, S, D = x.shape
    xf = x.reshape(B * S, D).to(dtype_of(cfg.compute_dtype))
    xin = xf if group is None else _CopyTo.apply(xf, group)
    probs, gate_vals, expert_ids, slot, keep = route(params["router"], xin,
                                                     cfg, group)
    out = _experts(params, xin, cfg, gate_vals, expert_ids, slot, keep,
                   lo=mesh.get_local_rank("model") * E_l, group=group)
    if m.shared_expert:
        out = out + _shared(params, xf, cfg)
    aux, drop = _aux(probs, expert_ids, keep, m)
    dp = axis_groups(mesh, current_rules()["act_batch"])
    if dp:
        aux, drop = _MeanOver.apply(aux, dp), _MeanOver.apply(drop, dp)
    return out.reshape(B, S, D), {"moe_aux": aux, "moe_drop": drop}
