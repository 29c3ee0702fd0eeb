"""Train, prefill and decode step bundles, with mesh-resolved shardings.

Counterpart of ``repro/train/steps.py``.  ``make_step_bundle(cfg, shape,
mesh=None)`` returns, by ``shape.kind``:

- ``train_step(state, batch)`` and the ``init_fn(generator)`` that makes
  its state, ``{"params": Model, "opt": AdamW state}`` (and ``"ef"``, the
  error-feedback buffers, under int8 compression).  The step updates the
  state in place and returns it with ``{"loss", "step"}``;
- ``prefill(params, inputs) -> (logits, cache)``;
- ``serve_step(params, cache, tokens, pos) -> (logits, cache)``.

``train_input_specs`` and ``serve_input_specs`` give the inputs' shapes
and dtypes as meta tensors (the reference's ``ShapeDtypeStruct``s), and
``decode_cache_rules`` the reference's adaptive decode-cache rule.

Microbatching follows the reference's ``accumulate``: the gradients of
``cfg.microbatches`` slices of the batch are summed in float32 buffers
(not in the parameters' ``.grad``, which would sum in their dtype) and
divided by their count; the loss is the mean of the slices' losses.
With one microbatch the gradients keep the parameters' dtype.

On a mesh (a ``DeviceMesh`` named with the reference's axes, one process
per device) the step is explicit SPMD, the counterpart of the reference's
jitted GSPMD step:

- the state is placed as the reference places it: each leaf is a DTensor
  whose placements come from the resolved spec of its logical axes
  (``in_shardings[0]``, the reference's ``_state_axes`` and state specs);
- every rank is given the whole global batch and takes its own rows
  (``batch_spec``).  Microbatch *i* is the global microbatch *i* split
  over the batch axes (under compression: the pod's microbatch *i* split
  over ``data``), as the reference's ``accumulate`` groups them;
- it computes on plain tensors, since the CUDA kernels take raw pointers:
  each leaf's compute view is its full value (the leaf's local tensor, not
  a copy, where every axis that splits it has size 1, as on one card),
  except where the work is split over ``model``: under expert parallelism
  this rank's experts (``models/moe.py``), and under the tensor-parallel
  plan (``distributed.sharding.tp_plan``, on ``StepBundle.tp``) this
  rank's ``model`` chunk of the attention, MLP, embedding and unembedding
  leaves, of the mamba, mLSTM and sLSTM mixers' leaves and of the MoE
  layers' router, experts and shared expert, gathered over the fsdp axes
  only (by c10d all-gathers, ``view_as``).  An expert leaf's view is its
  own storage chunk where nothing else splits it; where the
  expert-parallel route applies, its views (the same chunks) win.  Those
  layers run Megatron-style, column- and row-parallel with the
  collectives of ``distributed/collectives.py``, the loss
  vocab-parallel.  A gate leaf (mamba's ``in_proj``, the
  mLSTM's ``up_proj``, the sLSTM's ``w`` and ``b``) is stored as the
  reference stores it, but computes on the rank's chunk of each of its
  gate blocks (:func:`compute_view`), and its gradient is gathered back
  to the storage chunk after the batch average (``gate_chunk``).  With a
  ``model`` axis of one rank the same code runs, its collectives
  identities and every view the leaf's local tensor;
- the gradients are averaged over the batch axes; under int8 compression
  within the pod first, then across ``pod`` in int8 with error feedback
  (``optim/compress.py``), in the reference's layout with one scale per
  stacked leaf, so the tensor-parallel gradients are gathered over
  ``model`` first;
- each rank keeps its chunk of every gradient (a gradient split over
  ``model`` is cut over the other axes only), and AdamW updates the local
  chunks, clipped by the norm of the whole gradient (the split
  gradients' squares summed over ``model``).

Under ``seq_shard`` the plan splits the same kinds and marks the
sequence split: where the batch's sequence length divides ``model``, the
residual stream between the sublayers holds each rank's positions
(Megatron's sequence parallelism; ``distributed.sharding.sublayer_in``
and ``sublayer_out``), and a norm's gradient is summed over ``model``
by the model itself, so the step's gradients are each rank's as
without it.  Not tensor-parallel: a kind whose counts do not divide
``model`` (the plan says which); its ranks along ``model`` repeat the
work, which changes no result.

int8 compression raises under expert parallelism over a ``model`` axis
of more than one rank (the reference's own step fails there, ROADMAP
C13), not under the plan's "expert" or "expert_ffn" kinds: their
gradients are gathered whole over ``model`` before the quantizer, as
every split kind's (``tests/test_torch_tp.py``'s ``moe_int8``).

Serving.  Mesh-free, ``prefill`` is ``Model.prefill`` and ``serve_step``
``Model.decode_step``, with ``params`` a ``Model``.  On a mesh both are
explicit SPMD in the same way as the train step: ``params`` is a
``Model`` whose leaves are DTensors placed by their resolved specs
(:func:`place_params`, ``in_shardings[0]``); every rank is given the
whole global batch of inputs or tokens and takes its rows
(``batch_spec``); the layers the plan splits compute on the rank's
``model`` chunks through ``tp_plan``, as in the train step.  The outputs
are DTensors, placed where the reference leaves them to its partitioner
(``out_shardings``): the logits as the rows of the batch axes and whole
over the vocabulary (the rank's vocabulary columns are gathered over
``model``), the cache by ``cache_axes()`` plus
:func:`decode_cache_rules`.  The decode step reads each attention cache
leaf's local tensor (no copy) and writes position ``pos`` in place, the
counterpart of the reference's donated cache: split over ``model`` by
KV heads, each rank computes, writes and attends its own; split by
sequence (``cache_seq`` on ``model``, where the KV heads do not divide
it), each rank holds a chunk of the keys of every KV head, and the
attention merges the ranks' partials (``models/attention.py``).  The
recurrent cache leaves are placed by their specs (mamba's ``conv`` and
``ssm`` by ``inner``, the mLSTM's and sLSTM's states by ``heads``, on
``model``): where the plan splits the mixer, a decode step computes on
each leaf's local tensor, the rank's channels or heads, and writes the
new state into it; where it leaves the mixer whole, the step gathers the
leaves whole over ``model`` and writes back only its own chunk.  Under
``seq_shard`` a prefill splits the residual stream by sequence as the
train step does (its caches are the whole sequence's, as without it); a
decode step, one position, runs as plain tensor parallelism.  The dry
run (``launch/dryrun.py``) traces these bundles on fake tensors
and prices them (``analysis/``).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.distributed.collectives import gathered
from repro_torch.distributed.sharding import (
    P, NamedSharding, activation_sharding, axis_groups, batch_spec,
    aliases, distribute, gate_chunk, gate_view, local_chunk,
    resolve_axes_tree, tp_plan, view_as,
)
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import Model
from repro_torch.models.moe import _ep_applicable
from repro_torch.models.params import (
    dtype_of, from_jax_params, to_jax_params,
)
from repro_torch.obs.spans import spanned
from repro_torch.optim import AdamW, OptConfig, cosine_warmup
from repro_torch.optim.compress import compressed_pod_allreduce, ef_init


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------


def _inputs_meta(cfg: ArchConfig, B: int, S: int) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return torch.empty((B, S), dtype=torch.int32, device="meta")
    # vlm/audio stubs: precomputed patch/frame embeddings
    return torch.empty((B, S, cfg.d_model), dtype=dtype_of(cfg.compute_dtype),
                       device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {"inputs": _inputs_meta(cfg, B, S),
            "labels": torch.empty((B, S), dtype=torch.int32, device="meta")}


def serve_input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """Decode: one new token against a seq_len KV cache (the cache in the
    port's layout, one dict per group)."""
    B = shape.global_batch
    cache = Model(cfg, device="meta").init_cache(
        B, shape.seq_len, dtype_of(cfg.cache_dtype))
    return {"cache": cache, "tokens": _inputs_meta(cfg, B, 1),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def decode_cache_rules(cfg: ArchConfig, mesh) -> dict:
    """Adaptive decode-cache sharding.

    If KV heads don't divide the model axis (MQA/GQA with few KV heads),
    shard the cache *sequence* dim over "model" instead (context-parallel
    decode) so the cache doesn't replicate 16x.
    """
    m = mesh_axis_sizes(mesh).get("model", 1)
    return {"cache_seq": ("model",)} if cfg.n_kv_heads % m else {}


@dataclass
class StepBundle:
    cfg: ArchConfig
    shape: ShapeCfg
    mesh: Any                    # a DeviceMesh, or None
    step_fn: Callable            # train_step / prefill / serve_step
    init_fn: Optional[Callable] = None   # init_fn(generator) -> state
    # on a mesh: trees of NamedSharding (the reference's in_shardings /
    # out_shardings).  train: (state, batch) and (state, metrics);
    # prefill: (params, inputs) and (logits, cache); decode: (params,
    # cache, tokens, pos) and (logits, cache)
    in_shardings: Any = None
    out_shardings: Any = None
    # on a mesh: the tensor-parallel plan over "model" (a TPPlan: which
    # leaves compute on their "model" chunk)
    tp: Any = None


def make_opt(cfg: ArchConfig, total_steps: int = 100_000) -> AdamW:
    oc = OptConfig(state_dtype=cfg.opt_dtype)
    return AdamW(oc, cosine_warmup(oc.lr, 2_000, total_steps))


def make_step_bundle(cfg: ArchConfig, shape: ShapeCfg,
                     mesh=None) -> StepBundle:
    if shape.kind == "train":
        if mesh is None:
            return _train_bundle(cfg, shape)
        return _mesh_bundle(cfg, shape, mesh)
    if shape.kind == "prefill":
        return _prefill_bundle(cfg, shape, mesh)
    if shape.kind == "decode":
        return _decode_bundle(cfg, shape, mesh)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@torch.no_grad()
def _load_leaf(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` (a full value or a DTensor placed as ``dst``) into
    ``dst``, which a DTensor receives as its local chunk."""
    if isinstance(dst, DTensor):
        src = (src.to_local() if isinstance(src, DTensor)
               else local_chunk(src, dst.device_mesh, dst.placements))
        dst = dst.to_local()
    dst.copy_(src)


def load_state(state: dict, tree: dict) -> None:
    """Copy a port-form state (``models.params.from_jax_state``; its leaves
    full values, or DTensors placed as the state's) into ``state`` in
    place: parameters, both moments, the step and the error feedback."""
    params = dict(state["params"].named_parameters())
    if set(params) != set(tree["params"]):
        raise KeyError(f"parameter keys differ: "
                       f"{sorted(set(params) ^ set(tree['params']))}")
    for k, p in params.items():
        _load_leaf(p, tree["params"][k])
    opt = state["opt"]
    for part in ("m", "v"):
        for k, t in opt[part].items():
            _load_leaf(t, tree["opt"][part][k])
    _load_leaf(opt["step"], tree["opt"]["step"])
    for k, t in state.get("ef", {}).items():
        _load_leaf(t, tree["ef"][k])


def full_state(state: dict) -> dict:
    """The state's full values as plain tensors on each rank, in the
    state's layout (``{"params": {key: t}, "opt": {...}, "ef"}``); a
    DTensor's is gathered from its mesh (no copy where nothing is
    split)."""
    def full(tree):
        if isinstance(tree, dict):
            return {k: full(v) for k, v in tree.items()}
        return view_as(tree).detach()

    out = {"params": full(dict(state["params"].named_parameters())),
           "opt": full(state["opt"])}
    if "ef" in state:
        out["ef"] = full(state["ef"])
    return out


def place_state(cfg: ArchConfig, full: dict, shardings: dict):
    """The train state on a mesh, from full values that every rank holds
    (``full`` in the layout of :func:`full_state`): each leaf a DTensor of
    this rank's chunk, placed by its sharding (``in_shardings[0]``).  The
    parameters are a ``Model`` whose leaves are DTensors.  Returns None on
    a rank outside the mesh."""
    mesh = shardings["opt"]["step"].mesh
    if mesh.get_coordinate() is None:
        return None
    model = place_params(cfg, full["params"], shardings["params"])

    def place(vals, shs):
        if isinstance(shs, dict):
            return {k: place(vals[k], s) for k, s in shs.items()}
        return distribute(vals, shs)

    state = {"params": model, "opt": place(full["opt"], shardings["opt"])}
    if "ef" in shardings:
        state["ef"] = place(full["ef"], shardings["ef"])
    return state


def place_params(cfg: ArchConfig, full: dict, shardings: dict) -> Model:
    """A ``Model`` whose leaves are DTensors of this rank's chunks, placed
    by ``shardings`` ({key: NamedSharding}), from full values that every
    rank holds (``{key: tensor}``, keyed like the ``state_dict``)."""
    model = Model(cfg, device="meta")
    for key, p in list(model.named_parameters()):
        path, _, name = key.rpartition(".")
        leaf = nn.Parameter(distribute(full[key], shardings[key]),
                            requires_grad=False)
        leaf.init = p.init
        model.get_submodule(path)._parameters[name] = leaf
    return model


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _grads_of(model, batch):
    """A leaf the loss does not read (the embedding table of a config fed
    embeddings) gets a zero gradient, as ``jax.grad`` gives it; AdamW then
    treats it as the reference's does (no step, weight decay only)."""
    params = dict(model.named_parameters())
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip(params, grads)), loss.detach(), metrics


def _accumulate(model, batch, rows: list):
    """Gradients and loss over the microbatches ``batch[rows[i]]``: with
    one, the gradients keep the parameters' dtype; with more, their
    float32 sum over the microbatches, divided by their count."""
    if len(rows) == 1:
        return _grads_of(model, {key: t[rows[0]] for key, t in
                                 batch.items()})
    gsum = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in model.named_parameters()}
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["labels"].device)
    for r in rows:
        g, loss, _ = _grads_of(model, {key: t[r] for key, t in
                                       batch.items()})
        for name, gi in g.items():
            gsum[name].add_(gi.float())
        lsum = lsum + loss
    k = len(rows)
    return {name: g / k for name, g in gsum.items()}, lsum / k, {}


def _train_bundle(cfg: ArchConfig, shape: ShapeCfg) -> StepBundle:
    opt = make_opt(cfg)

    @spanned("train.step")
    def train_step(state, batch):
        model = state["params"]
        k = cfg.microbatches
        B = batch["labels"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{k} microbatches")
        n = B // k
        grads, loss, _ = _accumulate(
            model, batch, [slice(i * n, (i + 1) * n) for i in range(k)])
        opt.update(grads, state["opt"], dict(model.named_parameters()))
        return state, {"loss": loss, "step": state["opt"]["step"]}

    def init_fn(generator: torch.Generator) -> dict:
        """Parameters drawn from ``generator`` on its device, with
        gradients on; zero AdamW moments."""
        model = Model(cfg, device=generator.device).init_params(generator)
        model.requires_grad_(True)
        return {"params": model,
                "opt": opt.init(dict(model.named_parameters()))}

    return StepBundle(cfg, shape, None, train_step, init_fn)


# ---------------------------------------------------------------------------
# The mesh step
# ---------------------------------------------------------------------------


def _state_axes(param_axes: dict, compression: bool) -> dict:
    axes = {"params": param_axes,
            "opt": {"m": param_axes, "v": param_axes, "step": ()}}
    if compression:
        axes["ef"] = param_axes
    return axes


def _named(tree, mesh):
    if isinstance(tree, dict):
        return {k: _named(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_named(v, mesh) for v in tree]
    return NamedSharding(mesh, tree)


def _microbatch_rows(B: int, k: int, sizes: dict, coord: dict,
                     compression: bool) -> list:
    """This rank's rows of each microbatch: the global microbatch *i*
    split over the batch axes; under compression the pod's rows are
    microbatched, split over the axes left."""
    axes = [a for a in ("pod", "data") if a in sizes]
    n = math.prod(sizes[a] for a in axes)
    if B % (k * n):
        raise ValueError(f"batch {B} does not split into {k} microbatches "
                         f"over {n} batch shards")
    pods = sizes["pod"] if compression else 1
    pod = coord["pod"] if compression else 0
    idx = 0
    for a in axes:
        if not (compression and a == "pod"):
            idx = idx * sizes[a] + coord[a]
    block, per = B // pods, B // (k * n)
    return [slice(pod * block + i * (block // k) + idx * per,
                  pod * block + i * (block // k) + (idx + 1) * per)
            for i in range(k)]


def _bind(model: Model, tensors: dict) -> None:
    """Point ``model``'s leaves at ``tensors`` (no copy)."""
    for key, t in tensors.items():
        path, _, name = key.rpartition(".")
        model.get_submodule(path)._parameters[name] = t


@torch.no_grad()
def compute_view(t, placements=None, gates=None) -> torch.Tensor:
    """The plain tensor a rank computes with for a leaf ``t``: its value
    under ``placements`` (:func:`view_as`), or for a leaf of the plan's
    ``gates`` (``gates`` = (dim, blocks, rank, m, the ``model`` group),
    on more than one ``model`` rank) the rank's chunk of each gate block
    of the whole value (``gate_view``), the storage chunks gathered over
    ``model``."""
    if gates is None:
        return view_as(t, placements)
    d, blocks, rank, m, group = gates
    return gate_view(gathered(view_as(t, placements), group, d), d, blocks,
                     rank, m)


def _gate_views(tp, mesh) -> dict:
    """{key: (dim, blocks, rank, m, the ``model`` group)} of the plan's
    gate leaves on more than one ``model`` rank; {} on one, where each is
    its storage chunk (and on a rank outside the mesh)."""
    coord = mesh.get_coordinate()
    if tp.size <= 1 or coord is None:
        return {}
    rank = coord[list(mesh_axis_sizes(mesh)).index("model")]
    group = mesh.get_group("model")
    return {key: (tp.views[key], n, rank, tp.size, group)
            for key, n in tp.gates.items()}


def _expert_views(cfg, mesh, param_axes: dict, param_sh: dict, rows: int,
                  seq_len: int, exclude: tuple = ()) -> dict:
    """Under expert parallelism (``ep_shard``, where ``_ep_applicable`` to
    ``rows`` x ``seq_len`` tokens a rank): the placements of each expert
    leaf's compute view, this rank's experts; {} otherwise."""
    sizes = mesh_axis_sizes(mesh)
    with activation_sharding(mesh, cfg, exclude):
        ep = (cfg.moe is not None and cfg.moe.ep_shard and _ep_applicable(
            cfg, torch.empty((rows, seq_len, 0), device="meta"), mesh))
    views = {}
    if ep:
        for key, axes in param_axes.items():
            if "expert" in axes:
                d = axes.index("expert")
                views[key] = [Shard(d) if a == "model" else Replicate()
                              for a in sizes]
                if param_sh[key].placements[
                        list(sizes).index("model")] != Shard(d):
                    raise ValueError(f"{key}: its experts are not split "
                                     "over 'model'")
    return views


def _mesh_bundle(cfg: ArchConfig, shape: ShapeCfg, mesh) -> StepBundle:
    opt = make_opt(cfg)
    sizes = mesh_axis_sizes(mesh)
    compression = cfg.grad_compression == "int8" and "pod" in sizes
    exclude = ("pod",) if compression else ()
    batch_axes = tuple(a for a in ("pod", "data")
                       if a in sizes and a not in exclude)

    # --- shardings (the reference's state specs and batch shardings) ---
    compute = Model(cfg, device="meta")
    shapes, param_axes = compute.param_shapes()
    shapes_tree = {"params": shapes,
                   "opt": {"m": shapes, "v": shapes,
                           "step": torch.empty((), device="meta")}}
    if compression:
        # error-feedback buffers live per pod: placed like the params
        shapes_tree["ef"] = shapes
    state_sh = _named(resolve_axes_tree(_state_axes(param_axes, compression),
                                        shapes_tree, cfg, mesh), mesh)
    B = shape.global_batch
    bspec = batch_spec(mesh, extra_dims=1, batch_size=B)
    bspec3 = batch_spec(mesh, extra_dims=2, batch_size=B)
    batch_sh = {"inputs": NamedSharding(
        mesh, bspec if cfg.input_mode == "tokens" else bspec3),
        "labels": NamedSharding(mesh, bspec)}
    metrics_sh = {"loss": NamedSharding(mesh, P()),
                  "step": NamedSharding(mesh, P())}

    # --- expert parallelism: the expert leaves' view is this rank's experts
    rows_per_mb = B // (cfg.microbatches * math.prod(
        sizes[a] for a in ("pod", "data") if a in sizes))
    ep_view = _expert_views(cfg, mesh, param_axes, state_sh["params"],
                            rows_per_mb, shape.seq_len, exclude)
    if ep_view:
        if compression and sizes["model"] > 1:
            raise NotImplementedError(
                "int8 compression with expert parallelism over a model "
                "axis of more than one rank")

    # --- tensor parallelism: the dense leaves' view is this rank's chunk
    tp = tp_plan(cfg, sizes, param_axes,
                 {k: sh.spec for k, sh in state_sh["params"].items()})
    views = {key: tp.placements(key, sizes) for key in tp.views}
    views.update(ep_view)
    gates = _gate_views(tp, mesh)

    @spanned("train.step")
    def train_step(state, batch):
        model_group = (mesh.get_group("model")
                       if sizes.get("model", 1) > 1 else None)
        params = dict(state["params"].named_parameters())
        _bind(compute, {key: compute_view(p, views.get(key), gates.get(key))
                        .detach().requires_grad_()
                        for key, p in params.items()})
        coord = dict(zip(sizes, mesh.get_coordinate()))
        rows = _microbatch_rows(batch["labels"].shape[0], cfg.microbatches,
                                sizes, coord, compression)
        with activation_sharding(mesh, cfg, exclude, tp,
                                 seq_len=batch["labels"].shape[1]):
            grads, loss, _ = _accumulate(compute, batch, rows)
        _bind(compute, shapes)          # drop the views until the next step
        grads = {k: g.contiguous() for k, g in grads.items()}
        # average over the batch axes (within the pod under compression)
        n = math.prod(sizes[a] for a in batch_axes)
        for group in axis_groups(mesh, batch_axes):
            for t in (*grads.values(), loss):
                dist.all_reduce(t, group=group)
        if n > 1:
            for t in (*grads.values(), loss):
                t.div_(n)
        for key, (d, blocks, _, _, group) in gates.items():
            # a gate view's gradient back to the leaf's storage chunk
            grads[key] = gate_chunk(grads[key], group, d, blocks)
        split = set(views)          # gradients of this rank's model chunk
        if compression:
            # in the reference's layout: a stacked leaf has one scale, so
            # the tensor-parallel gradients are gathered whole first
            for key, d in tp.views.items():
                grads[key] = gathered(grads[key], model_group, d)
            split = set(ep_view)
            pods = sizes["pod"]
            pod_group = mesh.get_group("pod") if pods > 1 else None
            dev = loss.device
            grads, new_ef = compressed_pod_allreduce(
                to_jax_params(cfg, grads, dev),
                to_jax_params(cfg, {k: view_as(t) for k, t in
                                    state["ef"].items()}, dev), pod_group)
            grads = from_jax_params(cfg, grads)
            new_ef = from_jax_params(cfg, new_ef)
            for k, t in state["ef"].items():
                _load_leaf(t, new_ef[k])
            if pod_group is not None:
                dist.all_reduce(loss, group=pod_group)
                loss.div_(pods)
        # the norm of the whole gradient: a split leaf's rank holds only
        # its chunk
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in grads.values()])
        if split and model_group is not None:
            is_split = torch.tensor([k in split for k in grads],
                                    device=sq.device)
            part = torch.where(is_split, sq, 0.0)
            dist.all_reduce(part, group=model_group)
            sq = torch.where(is_split, part, sq)
        norm = torch.sqrt(sum(sq.unbind(0)))
        local = {}
        for key, g in grads.items():
            pl = state_sh["params"][key].placements
            if key in split:            # split over "model" already
                pl = [Replicate() if a == "model" else p
                      for a, p in zip(sizes, pl)]
            local[key] = local_chunk(g, mesh, pl)
        o = state["opt"]
        with torch.no_grad():
            opt_local = {"m": {k: t.to_local() for k, t in o["m"].items()},
                         "v": {k: t.to_local() for k, t in o["v"].items()},
                         "step": o["step"].to_local()}
            opt.update(local, opt_local,
                       {k: p.to_local() for k, p in params.items()},
                       norm=norm)
            o["step"].to_local().copy_(opt_local["step"])
        return state, {"loss": loss, "step": opt_local["step"]}

    def init_fn(generator: torch.Generator):
        """Parameters drawn from ``generator`` on its device (the same
        values on every rank), zero AdamW moments (and error feedback),
        placed on the mesh; None on a rank outside it."""
        model = Model(cfg, device=generator.device).init_params(generator)
        sd = {k: p.detach() for k, p in model.named_parameters()}
        full = {"params": sd, "opt": opt.init(sd)}
        if compression:
            full["ef"] = ef_init(sd)
        return place_state(cfg, full, state_sh)

    return StepBundle(cfg, shape, mesh, train_step, init_fn,
                      in_shardings=(state_sh, batch_sh),
                      out_shardings=(state_sh, metrics_sh), tp=tp)


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------


def _attn_layers(cfg: ArchConfig) -> set:
    return {f"l{i}" for i, layer in enumerate(cfg.pattern)
            if layer.mixer in ("attn", "attn_local")}


def _on_model(spec: P, d: int) -> bool:
    part = spec[d] if d < len(spec) else None
    return part == "model" or (isinstance(part, tuple) and "model" in part)


class _ServeMesh:
    """What the prefill and decode bundles share on a mesh: the parameter,
    input, logit and cache shardings, the tensor-parallel plan and the
    compute views, and how the cache splits over ``model``."""

    def __init__(self, cfg: ArchConfig, shape: ShapeCfg, mesh,
                 step_len: int):
        self.cfg, self.mesh = cfg, mesh
        sizes = self.sizes = mesh_axis_sizes(mesh)
        meta = Model(cfg, device="meta")
        self.shapes, param_axes = meta.param_shapes()
        self.param_sh = _named(resolve_axes_tree(param_axes, self.shapes,
                                                 cfg, mesh), mesh)
        B = shape.global_batch
        extra = 1 if cfg.input_mode == "tokens" else 2
        self.inputs_sh = NamedSharding(
            mesh, batch_spec(mesh, extra_dims=extra, batch_size=B))
        self.logits_sh = NamedSharding(
            mesh, batch_spec(mesh, extra_dims=2, batch_size=B))
        self.logits_shape = (B, 1, cfg.vocab_size)
        self.cache_shapes = meta.init_cache(B, shape.seq_len)
        self.cache_sh = _named(resolve_axes_tree(
            meta.cache_axes(), self.cache_shapes, cfg, mesh,
            decode_cache_rules(cfg, mesh)), mesh)
        self.tp = tp_plan(cfg, sizes, param_axes,
                          {k: sh.spec for k, sh in self.param_sh.items()})
        self.attn = _attn_layers(cfg)
        specs = [sh.spec for gc in self.cache_sh for name, lc in gc.items()
                 if name in self.attn for sh in lc["mixer"].values()]
        # K is (B, KV, hd, S) and V (B, KV, S, hd)
        kv_split = any(_on_model(sp, 1) for sp in specs)
        self.cache_seq = any(_on_model(sp, 3) or _on_model(sp, 2)
                             for sp in specs)
        if kv_split and sizes["model"] > 1 \
                and "kv_heads" not in self.tp.kinds:
            raise NotImplementedError(
                "a decode cache split by KV heads over 'model' needs the "
                "tensor-parallel plan to split the KV heads too")
        # the layers whose cache a decode step computes with in place: the
        # attention layers, and the recurrent mixers the plan splits, whose
        # states hold the rank's channels or heads (their cache specs put
        # the same counts on "model" as their leaves')
        self.local = self.attn | {
            f"l{i}" for i, layer in enumerate(cfg.pattern)
            if layer.mixer in ("mamba", "mlstm", "slstm")
            and layer.mixer in self.tp.kinds}
        rows = B // math.prod(sizes[a] for a in ("pod", "data")
                              if a in sizes)
        self.views = {key: self.tp.placements(key, sizes)
                      for key in self.tp.views}
        self.views.update(_expert_views(cfg, mesh, param_axes,
                                        self.param_sh, rows, step_len))
        self.gates = _gate_views(self.tp, mesh)
        # {params: (its leaves, the compute model bound to their views,
        # the views gathered per call)}
        self._bound = weakref.WeakKeyDictionary()

    def context(self, seq_len: int):
        """The model's context for a call over ``seq_len`` positions (a
        decode step: 1, which no ``model`` axis of more than one rank
        splits)."""
        return activation_sharding(self.mesh, self.cfg, (), self.tp,
                                   self.cache_seq, seq_len)

    @contextlib.contextmanager
    def bound(self, params: Model):
        """A compute model whose leaves are ``params``' compute views.  It
        is built at the first call with ``params`` and kept while they
        live: the views that are a leaf's own local tensor (every view on
        one rank) are bound once and follow in-place updates; the views
        that gather over a mesh axis are made for the duration of each
        call.  A leaf of ``params`` replaced by another rebuilds it."""
        leaves = tuple(params.parameters())
        entry = self._bound.get(params)
        if entry is None or any(a is not b for a, b in
                                zip(entry[0], leaves)):
            entry = self._bind_views(params, leaves)
        _, model, gathered = entry
        for module, name, p, placements, gates, _ in gathered:
            module._parameters[name] = compute_view(p, placements, gates)
        try:
            yield model
        finally:
            for module, name, _, _, _, meta in gathered:
                module._parameters[name] = meta

    def _bind_views(self, params: Model, leaves: tuple):
        model = Model(self.cfg, device="meta")
        own, gathered = {}, []
        for key, p in params.named_parameters():
            placements = self.views.get(key)
            gates = self.gates.get(key)
            if gates is None and aliases(p, placements):
                own[key] = view_as(p, placements)
            else:
                path, _, name = key.rpartition(".")
                gathered.append((model.get_submodule(path), name, p,
                                 placements, gates, self.shapes[key]))
        _bind(model, own)
        entry = self._bound[params] = (leaves, model, gathered)
        return entry

    def rows(self, inputs: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch ``inputs``."""
        return local_chunk(inputs, self.mesh, self.inputs_sh.placements)

    def logits(self, logits: torch.Tensor) -> DTensor:
        """This rank's rows of the logits, whole over the vocabulary."""
        return distribute(logits, self.logits_sh, self.logits_shape)

    def place_cache(self, cache: list) -> list:
        """A prefill's cache, computed on this rank, as DTensors placed by
        the cache shardings: the rank's chunk of each leaf (a leaf that
        the rank computed as its chunk, placed as it is)."""
        out = []
        for g, gc in enumerate(cache):
            out.append({})
            for name, lc in gc.items():
                shs = self.cache_sh[g][name]["mixer"]
                full = self.cache_shapes[g][name]["mixer"]
                out[g][name] = {"mixer": {
                    n: distribute(t, shs[n], full[n].shape)
                    for n, t in lc["mixer"].items()}}
        return out

    def compute_cache(self, cache: list) -> list:
        """The tensors a decode step computes with: the local tensor of
        each leaf of an attention layer (written in place) and of a
        recurrent mixer that the plan splits (its new states are written
        back into it); every other leaf gathered whole over ``model``
        (the rank's own rows)."""
        out = []
        for gc in cache:
            out.append({})
            for name, lc in gc.items():
                leaves = {}
                for n, t in lc["mixer"].items():
                    if name in self.local:
                        leaves[n] = t.to_local()
                    else:
                        leaves[n] = view_as(t, [
                            Replicate() if a == "model" else p
                            for a, p in zip(self.sizes, t.placements)])
                out[-1][name] = {"mixer": leaves}
        return out

    def write_back(self, cache: list, new: list) -> None:
        """Copy each recurrent state that a decode step computed into the
        cache's leaf: the whole new state of a mixer the plan splits (its
        rank's channels or heads), this rank's chunk of one computed whole
        over ``model``.  An attention layer's leaves were written in
        place."""
        for g, gc in enumerate(cache):
            for name, lc in gc.items():
                if name in self.attn:
                    continue
                shs = self.cache_sh[g][name]["mixer"]
                for n, t in lc["mixer"].items():
                    src = new[g][name]["mixer"][n]
                    if name not in self.local:
                        src = local_chunk(src, self.mesh, shs[n].placements,
                                          t.shape)
                    t.to_local().copy_(src)


def _prefill_bundle(cfg: ArchConfig, shape: ShapeCfg, mesh) -> StepBundle:
    if mesh is None:
        def prefill(params: Model, inputs):
            return params.prefill(inputs)

        return StepBundle(cfg, shape, None, prefill)
    sv = _ServeMesh(cfg, shape, mesh, shape.seq_len)

    def prefill(params: Model, inputs):
        """-> (logits (B, 1, V) and the cache, DTensors placed by
        ``out_shardings``)."""
        with sv.bound(params) as model, sv.context(inputs.shape[1]):
            logits, cache = model.prefill(sv.rows(inputs))
        return sv.logits(logits), sv.place_cache(cache)

    return StepBundle(cfg, shape, mesh, prefill,
                      in_shardings=(sv.param_sh, sv.inputs_sh),
                      out_shardings=(sv.logits_sh, sv.cache_sh), tp=sv.tp)


def _decode_bundle(cfg: ArchConfig, shape: ShapeCfg, mesh) -> StepBundle:
    if mesh is None:
        @spanned("serve.decode_step")
        def serve_step(params: Model, cache, tokens, pos):
            return params.decode_step(cache, tokens, int(pos))

        return StepBundle(cfg, shape, None, serve_step)
    sv = _ServeMesh(cfg, shape, mesh, 1)

    @spanned("serve.decode_step")
    def serve_step(params: Model, cache: list, tokens, pos):
        """-> (logits (B, 1, V), a DTensor placed by ``out_shardings[0]``,
        and ``cache``, written in place)."""
        local = sv.compute_cache(cache)
        with sv.bound(params) as model, sv.context(tokens.shape[1]):
            logits, new = model.decode_step(local, sv.rows(tokens), int(pos))
        sv.write_back(cache, new)
        return sv.logits(logits), cache

    return StepBundle(cfg, shape, mesh, serve_step,
                      in_shardings=(sv.param_sh, sv.cache_sh, sv.inputs_sh,
                                    NamedSharding(mesh, P())),
                      out_shardings=(sv.logits_sh, sv.cache_sh), tp=sv.tp)
