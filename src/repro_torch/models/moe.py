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
- slot positions come from a stable sort of the flat token-major expert
  ids (``_slots``): a pair's slot is its rank inside its expert's run of
  the sorted ids, and a stable sort keeps each run in token-major order,
  so the rank is the count of that expert's earlier pairs, which is what
  the reference's grouped two-level cumsum counts (integers, exact), with
  no host synchronisation;
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
  it: each rank computes its tokens' router logits, which are gathered
  over the batch axes, and every rank routes every token at the capacity
  of all of them; the tokens are gathered, each rank of the batch axes
  runs its share of every expert's slots where the capacity splits
  evenly (the reference splits the (E, C, D) buffer's capacity over the
  batch axes), and the outputs are reduce-scattered to each rank's
  tokens (else every rank runs every slot and keeps its own tokens);
  the shared expert runs on the rank's tokens.

On either route the tensor-parallel plan (``distributed.sharding``)
splits the layer over ``model``: "expert" gives each rank its E/m
experts (the router's columns gathered, as on the expert-parallel
route, but at the capacity of the routed batch), "expert_ffn" every
expert's ``d_ff`` columns, and "shared" the shared expert's, column-
then row-parallel; the parts are summed over ``model``.  With a
``model`` axis of one rank the code is the mesh-free code.  Under the
sequence split (``seq_shard``) the layer routes the gathered sequence:
its input's positions are gathered over ``model`` (``sublayer_in``; once
for the split experts and once more, with no sum in its gradient, for a
router that computes whole), and each part of its output goes back to
the rank's positions (``sublayer_out``).

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
    _CopyTo, _GatherCols, _GatherRows, _MeanOver, _ReduceScatterRows,
)
from repro_torch.distributed.sharding import (
    TPRank, axis_groups, current_mesh, current_rules, current_tp, seq_parts,
    sublayer_in, sublayer_out,
)
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import layers as L
from repro_torch.models.params import dense_init, dtype_of
from repro_torch.obs import spans


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


# The (token, choice) pairs that ``route`` decided while a profiler
# recorded (``obs.spans.on``), and of them those past their expert's
# capacity: the routed count on the host (it follows from the shapes),
# the dropped count in an int64 accumulator on each device, read once by
# ``pair_counts``.  Under remat the recompute routes again and counts
# again; the dropped share is the same.
pairs_routed = 0
_dropped: dict = {}


def _count_pairs(keep) -> None:
    global pairs_routed
    pairs_routed += keep.numel()
    acc = _dropped.get(keep.device)
    if acc is None:
        acc = _dropped[keep.device] = torch.zeros(
            (), dtype=torch.int64, device=keep.device)
    acc += keep.numel() - keep.sum()


def pair_counts() -> dict:
    """{"moe.pairs_routed", "moe.pairs_dropped"} since the last reset
    (reading the devices' accumulators waits for them)."""
    return {"moe.pairs_routed": pairs_routed,
            "moe.pairs_dropped": sum(int(a) for a in _dropped.values())}


def reset_pair_counts() -> None:
    global pairs_routed
    pairs_routed = 0
    _dropped.clear()


def _slots(expert_ids, E: int):
    """Each (token, choice) pair's position in its expert's buffer, in
    token-major order: ``slot`` (T*k,) int64, the number of earlier pairs
    (token-major) routed to the same expert of ``E``.  The ids are sorted
    stably as small integers (int16 up to 2**15 experts: fewer radix
    passes), so each expert's run keeps token-major order, and a pair's
    rank in its run (its sorted place less its run's first, found by
    ``searchsorted``) goes back to its own place."""
    key = torch.int16 if E <= 1 << 15 else torch.int32
    ids, order = torch.sort(expert_ids.to(key).reshape(-1), stable=True)
    rank = (torch.arange(ids.numel(), device=ids.device)
            - torch.searchsorted(ids, ids))
    return torch.empty_like(rank).scatter_(0, order, rank)


@spans.spanned("moe.route")
def route(router, xf, cfg, group=None, rows=()):
    """Routing of the flat tokens ``xf`` (T, D).

    Returns ``probs`` (T, E) float32, ``gate_vals`` (T, k) renormalised,
    ``expert_ids`` (T, k), and per (token, choice) pair in token-major
    order: ``slot`` (T*k,), the pair's position in its expert's buffer,
    and ``keep`` (T*k,), whether that position is below the capacity.
    With ``group`` (the expert-parallel route, the plan's "expert")
    ``router`` holds this rank's columns, and the logits are gathered
    over the group.  With ``rows`` (the groups of the batch axes, in mesh
    order) ``xf`` holds this rank's tokens, and the logits of every
    rank's are gathered (the minor axis first): T counts them all.
    """
    m = cfg.moe
    k, E = m.top_k, m.padded_experts()
    logits = xf.float() @ router.float()
    if group is not None:
        logits = _GatherCols.apply(logits, group)
    for g in reversed(rows):
        logits = _GatherRows.apply(logits, g)
    T = logits.shape[0]
    if E > m.num_experts:
        # dead experts never win the top-k
        col = torch.arange(E, device=xf.device)[None, :]
        logits = torch.where(col < m.num_experts, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :k], ids[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    slot = _slots(expert_ids, E)
    keep = slot < capacity_of(m, T)
    if spans.on():
        _count_pairs(keep)
    return probs, gate_vals, expert_ids, slot, keep


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def moe_apply(params, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), {"moe_aux", "moe_drop"}); under
    the sequence split, of the rank's positions."""
    mesh = current_mesh()
    if mesh is not None:
        if cfg.moe.ep_shard and _ep_applicable(cfg, x, mesh):
            return _moe_apply_ep(params, x, cfg, mesh)
        return _moe_apply_dense(params, x, cfg, axis_groups(
            mesh, current_rules()["act_tokens"]))
    return _moe_apply_dense(params, x, cfg)


def _experts(params, xin, cfg, gate_vals, expert_ids, slot, keep, *,
             lo: int = 0, slots=None, group=None):
    """Scatter the kept (token, choice) pairs of experts ``lo ..
    lo + E_l - 1`` (the expert leaves' rows) and of ``slots`` = (first,
    count) (default: all of the capacity) into their slots, run the
    experts, and combine each token's k contributions in choice order.
    Where the leaves hold fewer experts than the layer (expert parallel,
    or the "expert" kind of the tensor-parallel plan), or ``slots`` fewer
    slots than the capacity, the other pairs are left out: the output is
    this rank's part of the sum.  With ``group`` (the ``model`` ranks
    whose parts add: their experts, or every expert's ``d_ff`` columns
    under "expert_ffn") the gates' gradient is summed over it; the caller
    sums the parts."""
    cdt = dtype_of(cfg.compute_dtype)
    T, D = xin.shape
    k = cfg.moe.top_k
    E_l = params["w_up"].shape[0]
    C = capacity_of(cfg.moe, T)
    c_lo, C_l = (0, C) if slots is None else slots

    # scatter tokens into (E_l, C_l, D): each kept pair owns its slot
    with spans.span("moe.dispatch", backward=True) as sp:
        x = sp.input(xin)
        ids = expert_ids.reshape(T * k)
        if E_l < cfg.moe.padded_experts():
            keep = keep & (ids >= lo) & (ids < lo + E_l)
            ids = torch.where(keep, ids - lo, 0)
        if C_l < C:
            keep = keep & (slot >= c_lo) & (slot < c_lo + C_l)
            slot = slot - c_lo
        safe_slot = torch.where(keep, slot, 0)
        token_idx = torch.arange(T * k, device=xin.device) // k
        contrib = torch.where(keep[:, None], x[token_idx], 0)
        xe = sp.output(torch.zeros(
            (E_l, C_l, D), dtype=cdt, device=xin.device).index_put(
                (ids, safe_slot), contrib, accumulate=True))
    with spans.span("moe.experts"):
        ye = L.ffn(params, xe, cfg)                           # (E_l, C_l, D)

    # gather back and combine, token by token in choice order
    with spans.span("moe.combine", backward=True) as sp:
        ye, gates = sp.input(ye), sp.input(gate_vals).reshape(T * k)
        if group is not None:
            gates = _CopyTo.apply(gates, group)
        weights = torch.where(keep, gates, 0).to(cdt)
        parts = (ye[ids, safe_slot] * weights[:, None]).view(T, k, D)
        out = parts[:, 0]
        for j in range(1, k):
            out = out + parts[:, j]
        return sp.output(out)


def _routed(params, xin, xf, cfg, rows=()):
    """Route the flat tokens and run the experts, as the tensor-parallel
    plan splits them (``current_tp``): under "expert" this rank's
    experts, from the router's columns gathered; under "expert_ffn" every
    expert on this rank's ``d_ff`` columns, from the whole router;
    otherwise whole.  ``xin`` (T, D) is the experts' input (and the
    router's under "expert"), ``xf`` the same tokens as the whole router
    reads them (see ``sublayer_in``).  The output is this rank's part of
    the sum over ``model``.

    With ``rows`` (the batch axes' groups, in mesh order) ``xf`` holds
    this rank's tokens: the router's logits are gathered over them, every
    rank routes every token, at the capacity of all of them, and runs the
    experts on every rank's tokens; where the capacity splits evenly over
    the batch ranks each runs its share of every expert's slots, as the
    reference's partitioner splits the (E, C, D) buffer over the batch
    axes, and the parts are reduce-scattered to each rank's tokens.
    Returns (out of this rank's tokens (T, D), probs, expert_ids, keep),
    the last three of every token."""
    by_expert, by_ffn = current_tp("expert"), current_tp("expert_ffn")
    tp = by_expert or by_ffn
    group = None if tp is None else tp.group
    if by_expert is not None:
        probs, gate_vals, expert_ids, slot, keep = route(
            params["router"], xin, cfg, group, rows)
        lo = by_expert.rank * params["w_up"].shape[0]
    else:
        probs, gate_vals, expert_ids, slot, keep = route(
            params["router"], xf, cfg, rows=rows)
        lo = 0
    n, idx = 1, 0                           # this rank's place on rows
    for g in rows:
        size = dist.get_world_size(g)
        n, idx = n * size, idx * size + dist.get_rank(g)
    for g in reversed(rows):                # the minor axis first
        xin = _GatherRows.apply(xin, g)
    C = capacity_of(cfg.moe, xin.shape[0])
    slots = (idx * C // n, C // n) if rows and C % n == 0 else None
    out = _experts(params, xin, cfg, gate_vals, expert_ids, slot, keep,
                   lo=lo, slots=slots, group=group)
    if slots is not None:
        for g in rows:                      # the major axis first
            out = _ReduceScatterRows.apply(out, g)
    elif rows:
        out = out[idx * xf.shape[0]:(idx + 1) * xf.shape[0]]
    return out, probs, expert_ids, keep


def _shared(params, x, cfg):
    """The shared expert on the residual stream ``x`` (B, S, D), column-
    then row-parallel by its ``d_ff`` under the plan's "shared" kind."""
    shared = {"w_up": params["shared_up"], "w_down": params["shared_down"]}
    if cfg.gated_mlp:
        shared["w_gate"] = params["shared_gate"]
    return L.mlp(shared, x, cfg, tp=current_tp("shared"))


def _aux(probs, expert_ids, keep, m):
    """Switch-style load-balance loss and the dropped share of the pairs."""
    me = probs.mean(0)
    ce = F.one_hot(expert_ids[:, 0], probs.shape[1]).float().mean(0)
    return m.num_experts * torch.sum(me * ce), 1.0 - keep.float().mean()


def _moe_apply_dense(params, x, cfg, rows=()):
    """The dense route, over the tokens of every rank of ``rows`` (the
    batch axes' groups, in mesh order; none: this rank's tokens), as XLA
    computes it for the reference: the router's logits on this rank's
    tokens, gathered, and every token routed; the experts' slots split
    over the ranks (:func:`_routed`); the shared expert on this rank's
    tokens.  Returns this rank's tokens' output (under the sequence
    split, of its positions)."""
    m = cfg.moe
    x = x.to(dtype_of(cfg.compute_dtype))
    by_expert = current_tp("expert")
    tp = by_expert or current_tp("expert_ffn")
    xin = sublayer_in(x, tp)
    xf = xin if by_expert is not None or tp is None else sublayer_in(x,
                                                                     None)
    B, S, D = xin.shape
    # one view where the router and the experts read the same tensor, so
    # that its gradient sums their parts in one order on every route
    fin = xin.reshape(B * S, D)
    out, probs, expert_ids, keep = _routed(
        params, fin, fin if xf is xin else xf.reshape(B * S, D), cfg, rows)
    out = sublayer_out(out.reshape(B, S, D), tp)
    if m.shared_expert:
        out = out + _shared(params, x, cfg)
    aux, drop = _aux(probs, expert_ids, keep, m)
    return out, {"moe_aux": aux, "moe_drop": drop}


def _ep_applicable(cfg, x, mesh) -> bool:
    """The reference's test (``moe.py:165``) on the batch it sees: ``x``
    holds this rank's rows, split over the context's batch axes (and
    under the sequence split its positions)."""
    m = cfg.moe
    sizes = mesh_axis_sizes(mesh)
    if "model" not in sizes:
        return False
    dp_size = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    E = m.padded_experts()
    B = x.shape[0] * math.prod(sizes[a] for a in
                               current_rules().get("act_batch", ()))
    T = B * x.shape[1] * seq_parts()
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
    ep = TPRank(mesh.get_group("model") if n_model > 1 else None,
                mesh.get_local_rank("model"))
    x = x.to(dtype_of(cfg.compute_dtype))
    xin = sublayer_in(x, ep)
    B, S, D = xin.shape
    xin = xin.reshape(B * S, D)
    probs, gate_vals, expert_ids, slot, keep = route(params["router"], xin,
                                                     cfg, ep.group)
    out = sublayer_out(_experts(params, xin, cfg, gate_vals, expert_ids,
                                slot, keep, lo=ep.rank * E_l,
                                group=ep.group).reshape(B, S, D), ep)
    if m.shared_expert:
        out = out + _shared(params, x, cfg)
    aux, drop = _aux(probs, expert_ids, keep, m)
    dp = axis_groups(mesh, current_rules()["act_batch"])
    if dp:
        aux, drop = _MeanOver.apply(aux, dp), _MeanOver.apply(drop, dp)
    return out, {"moe_aux": aux, "moe_drop": drop}
