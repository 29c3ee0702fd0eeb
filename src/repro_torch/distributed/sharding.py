"""Logical-axis sharding rules, resolved per mesh with divisibility checks.

Counterpart of ``repro/distributed/sharding.py``.  The model tags every
parameter dim with a *logical* name ("embed", "ffn", "heads", ...; the
``axes`` of ``models.params.Init``).  This module maps logical names onto
mesh axes.  Resolution is defensive, as in the reference: a mesh axis is
only assigned when (a) the dim size is divisible by the product of the
mesh-axis sizes, and (b) the mesh axis is not already used by another dim
of the same tensor, so MQA (kv=1), GQA kv=4 on a 16-way axis or 40 experts
on 16 shards fall back to replication (or to the next dim).

A resolved :class:`P` (the reference's ``PartitionSpec``) becomes DTensor
placements with :func:`to_placements`: mesh dim *i* is ``Shard(d)`` if its
axis names tensor dim *d*, ``Replicate()`` otherwise.  Where one dim is
split over two axes (``("pod", "data")``) the first axis is the slower,
which is JAX's chunk order and DTensor's default order alike.

The rules read a mesh only through ``launch.mesh.mesh_axis_sizes``, so they
work on a ``DeviceMesh`` and on a ``(names, shape)`` stand-in.  The
reference's ``shard_map_compat`` has no counterpart: the port's mesh step
is explicit SPMD already (one process per device, collectives written out,
``train/steps.py``).

Tensor parallelism over ``model`` (:func:`tp_plan`) is what XLA derives
for the reference from the same specs: the dense layers whose heads,
``d_ff`` or vocabulary split evenly over ``model``, and the mamba, mLSTM
and sLSTM mixers whose ``d_inner`` and heads do, compute on each rank's
chunk of their leaves (Megatron's column- and row-parallel products),
as do the MoE layers' experts (by experts, or by their ``d_ff`` where the
experts do not divide ``model``) and shared expert.  Under ``seq_shard``
(``act_seq`` on ``model``) the same kinds split, and the residual stream
between the sublayers holds each rank's S/m positions (Megatron's
sequence parallelism, what XLA derives for the reference from the
residual's constraint): a split sublayer gathers the positions before its
column-parallel products and reduce-scatters its row-parallel outputs
back to them, a whole one gathers them and keeps its own
(:func:`sublayer_in`, :func:`sublayer_out`).  A call splits the sequence
only where its length divides ``model``, as the reference's resolution
drops ``act_seq`` from a dim it cannot divide: a decode step runs as
plain tensor parallelism.  The mesh step hands the plan to the model
through :class:`activation_sharding`, and the layers ask
:func:`current_tp` and :func:`current_seq`.
The serving bundles also tell the attention layers whether the decode
cache is split by sequence over ``model`` (:func:`current_cache_seq`:
``decode_cache_rules`` of ``train/steps.py`` put ``cache_seq`` there).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.collectives import (
    copy_to, gather_seq, gather_whole, gathered, reduce_from,
    reduce_scatter_seq, scatter_to,
)
from repro_torch.launch.mesh import mesh_axis_sizes


class _Unconstrained:
    def __repr__(self) -> str:
        return "UNCONSTRAINED"


class P(tuple):
    """A partition spec: per tensor dim, None (replicated), one mesh axis
    name, or a tuple of axis names (the dim split over their product).
    Trailing dims left out are replicated."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


# Default logical-axis -> mesh-axes candidates.  Order within the tuple is
# the sharding order; resolution drops axes that don't divide or collide.
def logical_rules(cfg, mesh) -> dict[str, tuple[str, ...]]:
    names = tuple(mesh_axis_sizes(mesh))
    fsdp: tuple[str, ...] = ()
    if getattr(cfg, "fsdp_params", False):
        fsdp = tuple(a for a in ("pod", "data") if a in names)
        if getattr(cfg, "grad_compression", "none") == "int8":
            # compressed cross-pod training: FSDP stays within the pod,
            # pods exchange int8 grads
            fsdp = tuple(a for a in fsdp if a != "pod")
    dp = tuple(a for a in ("pod", "data") if a in names)
    seq_axes: tuple[str, ...] = ()
    if getattr(cfg, "seq_shard", False):
        seq_axes = ("model",)     # sequence parallelism
    return {
        # activations
        "batch": dp,
        "act_batch": dp,
        "act_tokens": dp,         # flattened (B*S) token dim
        "seq": (),
        "act_seq": seq_axes,
        "cache_seq": (),          # overridden adaptively for decode caches
        # parameters
        "embed": fsdp,            # d_model dim of weights (ZeRO-3 when fsdp)
        "vocab": ("model",),
        "q_features": ("model",),
        "kv_features": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "expert": ("model",),
        "expert_ffn": ("model",),
        "inner": ("model",),      # mamba/mlstm inner dim
        "head_dim": (),
        "layers": (),             # the reference's stacked-scan leading dim
        "conv": (),
        "state": (),
        "low_rank": (),
    }


def resolve_spec(axes: tuple, shape: tuple, rules: dict, mesh) -> P:
    """Resolve one tensor's logical axes into a :class:`P`."""
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, axes):
        cand = rules.get(name, ()) if name else ()
        cand = tuple(a for a in cand if a in sizes and a not in used)
        # greedily keep the longest prefix of candidate axes that divides dim
        picked: tuple[str, ...] = ()
        for i in range(len(cand), 0, -1):
            prefix = cand[:i]
            if dim % math.prod(sizes[a] for a in prefix) == 0:
                picked = prefix
                break
        if picked:
            used.update(picked)
            out.append(picked if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def resolve_axes_tree(axes_tree, shapes_tree, cfg, mesh, extra_rules=None):
    """Resolve a tree of logical axes (dicts and lists, keyed like the
    ``state_dict`` or the cache) against a parallel tree of tensors (or
    anything with ``.shape``) into a tree of :class:`P`.  ``extra_rules``
    override entries of :func:`logical_rules` (decode caches)."""
    rules = logical_rules(cfg, mesh)
    if extra_rules:
        rules.update(extra_rules)

    def walk(axes, vals):
        if _is_axes(axes):
            return resolve_spec(axes, tuple(vals.shape), rules, mesh)
        if isinstance(axes, dict):
            return {k: walk(a, vals[k]) for k, a in axes.items()}
        return [walk(a, v) for a, v in zip(axes, vals)]

    return walk(axes_tree, shapes_tree)


def batch_spec(mesh, extra_dims: int = 1,
               batch_size: Optional[int] = None) -> P:
    """Spec for batch-major activations: batch over (pod, data).

    With ``batch_size``, axes that don't divide are dropped (suffix-first),
    so a batch of 1 replicates instead of failing.
    """
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if batch_size is not None:
        while axes and batch_size % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(lead, *([None] * extra_dims))


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.

    ``UNCONSTRAINED`` entries are replicated here (:func:`act_constrain`
    keeps a tensor's own placement for them)."""
    names = list(mesh_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None or part is P.UNCONSTRAINED:
            continue
        idx = [names.index(a) for a in
               (part if isinstance(part, tuple) else (part,))]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes of dim {d} are not in the mesh's "
                             f"order {names}, which DTensor cannot express")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def local_chunk(full: torch.Tensor, mesh, placements,
                shape=None) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``placements`` (a view).

    Several mesh dims sharding one tensor dim split it in mesh order, the
    first the slowest, as DTensor lays them out.  With ``shape`` (the
    global shape) a dim of ``full`` may already be this rank's chunk, and
    is kept: a rank that computes its own rows, or its own heads."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    shape = tuple(full.shape) if shape is None else tuple(shape)
    out = full
    for d in range(full.dim()):
        dims = [i for i, p in enumerate(placements)
                if isinstance(p, Shard) and p.dim == d]
        if not dims:
            continue
        n = math.prod(sizes[i] for i in dims)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not split into {n} "
                             "chunks")
        step = shape[d] // n
        if full.shape[d] == step:
            continue
        if full.shape[d] != shape[d]:
            raise ValueError(f"dim {d} of {tuple(full.shape)} is neither "
                             f"whole nor this rank's chunk of {shape}")
        idx = 0
        for i in dims:
            idx = idx * sizes[i] + coord[i]
        out = out.narrow(d, idx * step, step)
    return out


def distribute(full: torch.Tensor, sharding: NamedSharding,
               shape=None) -> DTensor:
    """A DTensor on ``sharding.mesh`` holding this rank's chunk of
    ``full``, which every rank holds whole (no communication), or with
    ``shape`` (the global shape) whole or already chunked dim by dim (see
    :func:`local_chunk`).  The chunk is the tensor itself, not a copy,
    where nothing is cut; otherwise it is copied so that ``full`` can be
    freed."""
    placements = sharding.placements
    shape = tuple(full.shape) if shape is None else tuple(shape)
    local = local_chunk(full, sharding.mesh, placements, shape)
    if local.numel() != full.numel():
        local = local.contiguous().clone()
    return DTensor.from_local(local, sharding.mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


@torch.no_grad()
def view_as(t, placements=None) -> torch.Tensor:
    """The plain tensor this rank computes with: a DTensor's value under
    ``placements`` (default all ``Replicate()``: the full value).  Where
    every mesh dim whose placement differs has size 1, that is the local
    tensor itself, with no copy; otherwise each mesh dim where ``t`` is
    ``Shard(d)`` and ``placements`` ``Replicate()`` is gathered along
    ``d`` by a c10d all-gather over that dim's group, the minor mesh dim
    first (the chunk order of :func:`local_chunk`), and the values are
    the DTensor's bit for bit.  Any other change of placement on a dim of
    more than one rank raises.  A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    if aliases(t, placements):
        return t.to_local()
    mesh = t.device_mesh
    if placements is None:
        placements = [Replicate()] * mesh.ndim
    out = t.to_local()
    for i in reversed(range(mesh.ndim)):
        have, want = t.placements[i], placements[i]
        if mesh.shape[i] == 1 or have == want:
            continue
        if not (isinstance(have, Shard) and want == Replicate()) or any(
                placements[k] == have for k in range(i + 1, mesh.ndim)
                if mesh.shape[k] > 1):
            raise ValueError(f"mesh dim {i}: cannot gather {have} into "
                             f"{want} under {list(placements)}")
        out = gathered(out, mesh.get_group(i), have.dim)
    return out


def aliases(t, placements=None) -> bool:
    """Whether ``view_as(t, placements)`` is ``t``'s own storage (a plain
    tensor, or a DTensor whose every mesh dim with another placement has
    size 1), so that it follows in-place updates of ``t``."""
    if not isinstance(t, DTensor):
        return True
    mesh = t.device_mesh
    if placements is None:
        placements = [Replicate()] * mesh.ndim
    return all(n == 1 or a == b for n, a, b in
               zip(mesh.shape, t.placements, placements))


# ---------------------------------------------------------------------------
# Tensor parallelism over "model"
# ---------------------------------------------------------------------------

# what splits each kind of leaf over "model": its logical axes (the first
# of them in a leaf's axes is the dim split)
_TP_AXIS = {"heads": ("q_features",), "kv_heads": ("kv_features",),
            "ffn": ("ffn",), "vocab": ("vocab",), "mamba": ("inner",),
            "mlstm": ("inner", "heads"), "slstm": ("inner", "heads"),
            "slstm_ffn": ("ffn",), "expert": ("expert",),
            "expert_ffn": ("expert_ffn",), "shared": ("ffn",)}
# the leaves whose split dim is several gate blocks side by side ([x | z],
# [i | f | z | o]): stored as a contiguous chunk of the whole dim, they
# compute on each block's chunk (see TPPlan)
_GATES = {"mamba": {"in_proj": 2}, "mlstm": {"up_proj": 2},
          "slstm": {"w": 4, "b": 4}}


@dataclass(frozen=True)
class TPPlan:
    """Which layers compute on this rank's ``model`` chunk.

    ``kinds``: of "heads" (``wq``/``bq`` column-parallel by heads, ``wo``
    row-parallel), "kv_heads" (``wk``/``wv``/``bk``/``bv`` column-parallel;
    without it a head-parallel layer computes the KV heads its query heads
    read from the whole leaves), "ffn" (``w_up``/``w_gate`` column-,
    ``w_down`` row-parallel), "vocab" (``embedding`` by rows and
    ``unembed`` by columns), and the recurrent mixers: "mamba" (its
    ``d_inner`` channels), "mlstm" (its heads and their ``d_inner``
    features), "slstm" (its heads) and "slstm_ffn" (the sLSTM block's
    post-FFN by its width, column- then row-parallel; it splits on its own
    count, so it may split where "slstm" does not, and the reverse); and
    the MoE layer: "expert" (the ``router``'s columns and the expert
    leaves ``w_up``/``w_gate``/``w_down`` by their experts: each rank
    runs its experts, at the capacity of the whole routed batch, and the
    outputs are summed over ``model``), "expert_ffn" (the expert leaves by
    their ``d_ff``, where the experts do not divide ``model``: every rank
    runs every expert on its columns, column- then row-parallel) and
    "shared" (the shared expert by its ``d_ff``, as "ffn").  Where the
    MoE layer takes the expert-parallel route (``ep_shard``, where
    ``models.moe._ep_applicable`` holds) that route's views, this rank's
    experts at a local capacity, win over "expert" and "expert_ffn"
    (``train/steps.py``); the new kinds apply where it does not:
    ``ep_shard`` off, or a decode step with too few tokens a rank.
    ``views``: {leaf key: the dim of the leaf split over ``model``} for
    the leaves of those kinds; every other leaf's compute view is its
    whole value.  ``gates``: {leaf key: blocks} for the leaves of
    ``views`` whose split dim is that many gate blocks side by side
    (mamba's ``in_proj`` [x | z], the mLSTM's ``up_proj`` [x | z], the
    sLSTM's ``w`` and ``b`` [i | f | z | o]): they are stored as the
    reference stores them, rank r holding the r-th contiguous chunk of
    the whole dim, but rank r computes on the r-th chunk of each block
    (:func:`gate_view`), and its gradient goes back to the storage chunk
    (:func:`gate_chunk`).  On one rank the two are the same.  ``seq``:
    the activations' sequence is split over ``model`` (``seq_shard``),
    where a call's sequence length divides the ``model`` size (see
    :class:`activation_sharding`)."""

    size: int                   # ranks on "model" (0: no such axis)
    kinds: frozenset
    views: dict
    gates: dict
    seq: bool = False

    def placements(self, key: str, names) -> Optional[list]:
        """The DTensor placements of ``key``'s storage chunk on a mesh
        with axes ``names``: its ``model`` chunk, whole over the other
        axes; None for a whole leaf.  For a leaf of ``gates`` this is not
        its compute view (see :func:`gate_view`)."""
        d = self.views.get(key)
        if d is None:
            return None
        return [Shard(d) if a == "model" else Replicate() for a in names]


def _tp_kinds(cfg, key: str) -> tuple:
    """The kinds that tensor parallelism can split a leaf by (keys as the
    ``state_dict``'s: ``embed.embedding``, ``groups.<g>.l<j>.mixer.wq``):
    one, or for an expert leaf of an MoE layer two ("expert" by its
    experts, "expert_ffn" by their ``d_ff``; the resolved spec puts at
    most one of the two dims on ``model``); none for the sLSTM's
    post-norm."""
    parts = key.split(".")
    if parts[0] == "embed":
        return ("vocab",)
    if parts[0] != "groups":
        return ()
    layer = cfg.pattern[int(parts[2][1:])]
    if parts[3] == "mixer":
        if layer.mixer in ("attn", "attn_local"):
            return (("kv_heads",) if parts[4] in ("wk", "wv", "bk", "bv")
                    else ("heads",))
        if layer.mixer == "slstm":
            return {"ffn_up": ("slstm_ffn",), "ffn_down": ("slstm_ffn",),
                    "norm_scale": ()}.get(parts[4], ("slstm",))
        return (layer.mixer,)       # mamba, mlstm
    if parts[3] == "ffn" and layer.ffn == "mlp":
        return ("ffn",)
    if parts[3] == "ffn" and layer.ffn == "moe":
        if parts[4] == "router":
            return ("expert",)
        if parts[4].startswith("shared_"):
            return ("shared",)
        return ("expert", "expert_ffn")     # w_up, w_gate, w_down
    return ()


def _tp_counts(cfg, kind: str) -> tuple:
    """The counts that must divide the ``model`` size for ``kind`` to
    split."""
    if kind == "mamba":
        return (cfg.d_inner_mamba,)
    if kind == "mlstm":
        return (cfg.d_inner_mlstm, cfg.n_heads)
    if kind == "slstm":
        return (cfg.n_heads, 4 * cfg.d_model)
    if kind == "slstm_ffn":
        return (int(cfg.xlstm.slstm_proj_factor * cfg.d_model),)
    if kind == "expert":
        return (cfg.moe.padded_experts(),)
    if kind in ("expert_ffn", "shared"):
        return (cfg.moe.d_ff,)
    return ({"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
             "ffn": cfg.d_ff, "vocab": cfg.vocab_size}[kind],)


def tp_plan(cfg, sizes: dict, param_axes: dict, specs: dict) -> TPPlan:
    """The tensor-parallel plan of a model on a mesh with axis ``sizes``,
    from its leaves' logical axes and resolved specs ({key: P}).  A kind
    is split when its counts (query heads, KV heads, ``d_ff``, vocabulary,
    a recurrent mixer's ``d_inner`` and heads, the sLSTM's gate width or
    its post-FFN's width) divide the ``model`` size and every leaf of the
    kind is stored split over ``model`` along that axis; "kv_heads" also
    needs "heads".  A kind that does not split computes whole on every
    ``model`` rank.  A ``model`` axis of one rank splits every kind
    present (the same code runs, its collectives identities).  Under
    ``seq_shard`` the same kinds split, and the plan marks the sequence
    split (``seq``)."""
    m = sizes.get("model", 0)
    leaves: dict = {}
    gates: dict = {}
    for key, axes in param_axes.items():
        for kind in _tp_kinds(cfg, key):
            leaves.setdefault(kind, {})[key] = min(
                i for i, a in enumerate(axes) if a in _TP_AXIS[kind])
            n = _GATES.get(kind, {}).get(key.rpartition(".")[2])
            if n:
                gates[key] = n

    def stored_on_model(key, d):
        spec = specs[key]
        return d < len(spec) and spec[d] == "model"

    kinds = {kind for kind, dims in leaves.items()
             if m and all(n % m == 0 for n in _tp_counts(cfg, kind))
             and all(stored_on_model(k, d) for k, d in dims.items())}
    if "heads" not in kinds:
        kinds.discard("kv_heads")
    views = {k: d for kind in sorted(kinds) for k, d in leaves[kind].items()}
    return TPPlan(m, frozenset(kinds), views,
                  {k: n for k, n in gates.items() if k in views},
                  bool(m) and bool(getattr(cfg, "seq_shard", False)))


def gate_view(whole: torch.Tensor, dim: int, gates: int, rank: int,
              m: int) -> torch.Tensor:
    """Of a leaf whose ``dim`` is ``gates`` blocks side by side, the
    ``rank``-th of ``m`` chunks of each block, side by side: what rank
    ``rank`` computes with (its channels of x and of z, its heads' four
    gates).  With one rank, ``whole`` itself."""
    if m == 1:
        return whole
    w = whole.shape[dim] // (gates * m)
    return torch.cat([whole.narrow(dim, (g * m + rank) * w, w)
                      for g in range(gates)], dim)


def gate_chunk(view: torch.Tensor, group, dim: int,
               gates: int) -> torch.Tensor:
    """The inverse of :func:`gate_view` over ``group``: from each rank's
    view (a gradient of it, say), this rank's contiguous storage chunk of
    the whole dim, by an all-gather (no sums: each entry of the chunk
    comes from one rank's view).  With ``group`` None, ``view`` itself."""
    if group is None:
        return view
    m, rank = dist.get_world_size(group), dist.get_rank(group)
    every = gathered(view.contiguous(), group, dim)  # rank-major blocks
    w = view.shape[dim] // gates
    # storage block p (of gates * m) is gate p // m of rank p % m
    return torch.cat([every.narrow(dim, ((p % m) * gates + p // m) * w, w)
                      for p in range(rank * gates, (rank + 1) * gates)],
                     dim)


@dataclass(frozen=True)
class TPRank:
    """This rank's place on ``model`` while a plan is active: the group
    (None for one rank, where the collectives are identities) and its rank
    in the group."""

    group: object
    rank: int


def constrain(x, spec: P):
    """``with_sharding_constraint``: a DTensor is redistributed to ``spec``
    on its own mesh; a plain tensor (no mesh) is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def axis_groups(mesh, axes) -> list:
    """The process groups of the named mesh dims of size > 1, in mesh
    order (a collective over several axes runs over each in turn)."""
    sizes = mesh_axis_sizes(mesh)
    return [mesh.get_group(a) for a in sizes if a in axes and sizes[a] > 1]


# ---------------------------------------------------------------------------
# Activation constraints (ambient, set by the mesh train step)
# ---------------------------------------------------------------------------

class _Ctx(NamedTuple):
    mesh: object
    rules: dict
    tp: Optional[TPPlan]
    rank: Optional[TPRank]          # where the plan splits a kind
    cache_seq: Optional[TPRank]     # the decode cache split by sequence
    seq: Optional[TPRank]           # the activations split by sequence


_ACT_CTX: list = []  # stack of _Ctx


class activation_sharding:
    """Context manager: model code resolves against this mesh while a step
    runs (the MoE layer's expert-parallel and gathered routes read it
    through :func:`current_mesh`, the dense layers the tensor-parallel
    plan ``tp`` through :func:`current_tp`).  No context: single-device
    code.  ``exclude`` drops mesh axes from every rule: the compressed step
    runs each pod's gradients on their own, as the reference's pod-manual
    region does.  ``cache_seq``: the decode cache's sequence is split over
    ``model`` (the serving bundles; :func:`current_cache_seq`).
    ``seq_len``: the call's sequence length; where the plan splits the
    sequence (``tp.seq``) and ``seq_len`` divides the ``model`` size, the
    residual stream holds this rank's positions (:func:`current_seq`)."""

    def __init__(self, mesh, cfg, exclude: tuple = (),
                 tp: Optional[TPPlan] = None, cache_seq: bool = False,
                 seq_len: Optional[int] = None):
        if mesh is None:
            self.entry = None
        else:
            rules = logical_rules(cfg, mesh)
            if exclude:
                rules = {k: tuple(a for a in v if a not in exclude)
                         for k, v in rules.items()}
            split = tp is not None and bool(tp.kinds)
            m = mesh_axis_sizes(mesh).get("model", 0)
            seq = (tp is not None and tp.seq and seq_len is not None
                   and seq_len % m == 0)
            here = None
            if split or cache_seq or seq:
                here = TPRank(mesh.get_group("model") if m > 1 else None,
                              mesh.get_local_rank("model"))
            self.entry = _Ctx(mesh, rules, tp, here if split else None,
                              here if cache_seq else None,
                              here if seq else None)

    def __enter__(self):
        if self.entry is not None:
            _ACT_CTX.append(self.entry)
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            _ACT_CTX.pop()
        return False


def current_mesh():
    """The mesh of the innermost activation-sharding context (or None)."""
    return _ACT_CTX[-1].mesh if _ACT_CTX else None


def current_rules() -> dict:
    """The rules of the innermost activation-sharding context ({} if
    none)."""
    return _ACT_CTX[-1].rules if _ACT_CTX else {}


def current_tp(kind: str) -> Optional[TPRank]:
    """This rank's :class:`TPRank` when the innermost context's plan
    splits ``kind`` (one of :class:`TPPlan`'s kinds) over ``model``; None
    otherwise (no context, no plan, or the kind computes whole)."""
    if not _ACT_CTX:
        return None
    ctx = _ACT_CTX[-1]
    return ctx.rank if ctx.tp is not None and kind in ctx.tp.kinds else None


def current_cache_seq() -> Optional[TPRank]:
    """This rank's place on ``model`` when the innermost context's decode
    cache is split by sequence over ``model`` (this rank holds keys
    ``rank * S_l .. (rank + 1) * S_l - 1`` of every KV head); None
    otherwise."""
    return _ACT_CTX[-1].cache_seq if _ACT_CTX else None


def current_seq() -> Optional[TPRank]:
    """This rank's place on ``model`` when the innermost context splits
    the activations' sequence over ``model`` (the residual stream holds
    positions ``rank * S_l .. (rank + 1) * S_l - 1``); None otherwise."""
    return _ACT_CTX[-1].seq if _ACT_CTX else None


def seq_parts() -> int:
    """How many parts the activations' sequence is split into (1: not
    split)."""
    seq = current_seq()
    return 1 if seq is None or seq.group is None else \
        dist.get_world_size(seq.group)


def sublayer_in(x, tp: Optional[TPRank]):
    """The input of a sublayer from the residual stream ``x`` (B, S, D):
    with ``tp`` (the plan splits the sublayer: each rank computes its
    share of the whole sequence, and the input's gradient is the sum of
    the ranks' parts) Megatron's f, or under the sequence split the
    positions gathered (their gradient reduce-scattered); without it (the
    sublayer computes whole on every rank) ``x`` itself, or under the
    sequence split the positions gathered with no sum in the gradient."""
    seq = current_seq()
    if seq is None:
        return x if tp is None else copy_to(x, tp.group)
    return (gather_whole(x, seq.group) if tp is None
            else gather_seq(x, seq.group))


def sublayer_out(x, tp: Optional[TPRank]):
    """The output of a sublayer back to the residual stream: with ``tp``
    (``x`` is this rank's part of the sum) Megatron's g, or under the
    sequence split the sum reduce-scattered to the rank's positions;
    without it (``x`` is whole) ``x`` itself, or under the sequence split
    the rank's positions (the gradient gathered)."""
    seq = current_seq()
    if seq is None:
        return x if tp is None else reduce_from(x, tp.group)
    return (scatter_to(x, seq.group, 1) if tp is None
            else reduce_scatter_seq(x, seq.group))


def seq_param(p):
    """A replicated leaf that a rank applies to its own positions only
    (the norms of the residual stream under the sequence split): its
    gradient is summed over ``model``; otherwise ``p`` itself."""
    seq = current_seq()
    return p if seq is None else copy_to(p, seq.group)


def seq_whole(x):
    """The residual stream ``x`` with every position (no gradient: the
    prefill's last logits)."""
    seq = current_seq()
    return x if seq is None else gathered(x, seq.group, 1)


def act_constrain(x, logical_axes: tuple):
    """Pin an activation's placement by logical axis names (or None).

    The mesh step computes on plain local tensors (each rank its own rows,
    ``train/steps.py``), so there this returns ``x`` unchanged, as it does
    outside a context.  A DTensor is redistributed to the resolved spec;
    a dim whose rule exists but fails divisibility keeps the placement it
    has (the reference's ``UNCONSTRAINED``), and a ``None``-named dim is
    replicated."""
    if not _ACT_CTX or not isinstance(x, DTensor):
        return x
    mesh, rules = _ACT_CTX[-1].mesh, _ACT_CTX[-1].rules
    spec = resolve_spec(logical_axes, tuple(x.shape), rules, mesh)
    parts = list(spec) + [None] * (x.ndim - len(spec))
    if all(p is None for p in parts):
        return x
    free = {d for d, (name, p) in enumerate(zip(logical_axes, parts))
            if p is None and name is not None and rules.get(name)}
    target = to_placements(P(*parts), mesh)
    for i, (have, want) in enumerate(zip(x.placements, target)):
        if isinstance(have, Shard) and have.dim in free \
                and want == Replicate():
            target[i] = have
    return x.redistribute(mesh, target)
