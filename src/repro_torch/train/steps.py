"""The train step: loss, gradients (optionally over microbatches), AdamW.

Counterpart of ``repro/train/steps.py``'s train bundle.
``make_step_bundle(cfg, shape, mesh=None)`` returns the
``train_step(state, batch)`` and the ``init_fn(generator)`` that makes its
state, ``{"params": Model, "opt": AdamW state}`` (and ``"ef"``, the
error-feedback buffers, under int8 compression).  The step updates the
state in place and returns it with ``{"loss", "step"}``.

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
  leaves, gathered over the fsdp axes only.  Those layers run
  Megatron-style, column- and row-parallel with the collectives of
  ``distributed/collectives.py``, the loss vocab-parallel; with a
  ``model`` axis of one rank the same code runs, its collectives
  identities;
- the gradients are averaged over the batch axes; under int8 compression
  within the pod first, then across ``pod`` in int8 with error feedback
  (``optim/compress.py``), in the reference's layout with one scale per
  stacked leaf, so the tensor-parallel gradients are gathered over
  ``model`` first;
- each rank keeps its chunk of every gradient (a gradient split over
  ``model`` is cut over the other axes only), and AdamW updates the local
  chunks, clipped by the norm of the whole gradient (the split
  gradients' squares summed over ``model``).

Not tensor-parallel (ROADMAP A11c): the mamba and xLSTM leaves, the
experts of the MoE layer's route without expert parallelism, and
``seq_shard``; their ranks along ``model`` repeat the work, which changes
no result.  Not ported yet: the prefill and decode bundles and the input
specs of the dry run (ROADMAP A12).
"""
from __future__ import annotations

import math
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
    distribute, local_chunk, resolve_axes_tree, tp_plan, view_as,
)
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import Model
from repro_torch.models.moe import _ep_applicable
from repro_torch.models.params import from_jax_params, to_jax_params
from repro_torch.optim import AdamW, OptConfig, cosine_warmup
from repro_torch.optim.compress import compressed_pod_allreduce, ef_init


def train_input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    raise NotImplementedError("input specs of the dry run are not ported "
                              "to repro_torch yet (ROADMAP A12)")


def serve_input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    raise NotImplementedError("input specs of the dry run are not ported "
                              "to repro_torch yet (ROADMAP A12)")


@dataclass
class StepBundle:
    cfg: ArchConfig
    shape: ShapeCfg
    mesh: Any                    # a DeviceMesh, or None
    step_fn: Callable            # train_step(state, batch)
    init_fn: Optional[Callable] = None   # init_fn(generator) -> state
    # on a mesh: (state shardings, batch shardings) and (state shardings,
    # metrics shardings), trees of NamedSharding (the reference's
    # in_shardings / out_shardings)
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
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind!r} step bundles are not "
                                  "ported to repro_torch yet (ROADMAP A12)")
    if mesh is None:
        return _train_bundle(cfg, shape)
    return _mesh_bundle(cfg, shape, mesh)


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
    model = Model(cfg, device="meta")
    for key, p in list(model.named_parameters()):
        path, _, name = key.rpartition(".")
        leaf = nn.Parameter(distribute(full["params"][key],
                                       shardings["params"][key]),
                            requires_grad=False)
        leaf.init = p.init
        model.get_submodule(path)._parameters[name] = leaf

    def place(vals, shs):
        if isinstance(shs, dict):
            return {k: place(vals[k], s) for k, s in shs.items()}
        return distribute(vals, shs)

    state = {"params": model, "opt": place(full["opt"], shardings["opt"])}
    if "ef" in shardings:
        state["ef"] = place(full["ef"], shardings["ef"])
    return state


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _grads_of(model, batch):
    params = dict(model.named_parameters())
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
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
    with activation_sharding(mesh, cfg, exclude):
        ep = (cfg.moe is not None and cfg.moe.ep_shard and _ep_applicable(
            cfg, torch.empty((rows_per_mb, shape.seq_len, 0),
                             device="meta"), mesh))
    ep_view = {}
    if ep:
        for key, axes in param_axes.items():
            if "expert" in axes:
                d = axes.index("expert")
                ep_view[key] = [Shard(d) if a == "model" else Replicate()
                                for a in sizes]
                if state_sh["params"][key].placements[
                        list(sizes).index("model")] != Shard(d):
                    raise ValueError(f"{key}: its experts are not split "
                                     "over 'model'")
        if compression and sizes["model"] > 1:
            raise NotImplementedError(
                "int8 compression with expert parallelism over a model "
                "axis of more than one rank")

    # --- tensor parallelism: the dense leaves' view is this rank's chunk
    tp = tp_plan(cfg, sizes, param_axes,
                 {k: sh.spec for k, sh in state_sh["params"].items()})
    views = {key: tp.placements(key, sizes) for key in tp.views}
    views.update(ep_view)

    def train_step(state, batch):
        model_group = (mesh.get_group("model")
                       if sizes.get("model", 1) > 1 else None)
        params = dict(state["params"].named_parameters())
        _bind(compute, {key: view_as(p, views.get(key)).detach()
                        .requires_grad_() for key, p in params.items()})
        coord = dict(zip(sizes, mesh.get_coordinate()))
        rows = _microbatch_rows(batch["labels"].shape[0], cfg.microbatches,
                                sizes, coord, compression)
        with activation_sharding(mesh, cfg, exclude, tp):
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
