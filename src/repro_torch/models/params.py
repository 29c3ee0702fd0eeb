"""Parameter trees as ``nn.Module``s, initializers, and the JAX bridge.

The reference builds nested dicts of arrays (``repro/models/params.py``).
Here every dict node is a :class:`ParamTree` module and every leaf an
``nn.Parameter`` (``requires_grad=False`` until a trainer asks for
gradients: serving needs none), so a ``state_dict`` key is the
reference's tree path — ``groups.3.l0.mixer.wq`` — with the scanned group
axis unrolled into a ``ModuleList``.  Nodes
index like dicts (``p["wq"]``), so the layer functions take a module or a
plain dict of tensors alike.

Initializers mirror ``dense_init`` / ``embed_init`` / ``zeros`` / ``ones``
(``params.py:66-81``) and the xLSTM constants: the same distributions
and leaf dtypes, drawn from a ``torch.Generator`` on the target device.
A torch generator gives other numbers than a JAX key, so parity tests
load the reference's values with :func:`from_jax_params` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import NamedSharding, P


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to "
                           "run on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclass(frozen=True)
class Init:
    """A leaf to be created: its shape, its logical axes, how it is drawn,
    and its dtype.

    ``axes`` names each dim with a logical axis of
    ``distributed.sharding.logical_rules`` ("embed", "ffn", "expert", ...)
    or None, as the reference's ``pmeta`` does; the sharding rules turn
    them into a placement on any mesh.  ``dtype`` None takes the tree's
    ``param_dtype``; the reference keeps some leaves in float32 whatever
    that is (the xLSTM gate biases and recurrent weights).  ``scale``
    replaces a dense leaf's ``1/sqrt(fan_in)``.  A ``const`` leaf is split
    along its first axis into ``len(values)`` equal blocks, block ``j``
    filled with ``values[j]``.  A ``log_arange`` leaf (the mamba
    ``A_log``) holds ``log(1..N)`` along its last axis, N = ``shape[-1]``,
    in every row.
    """

    shape: tuple
    axes: tuple
    kind: str  # dense | embed | const | log_arange
    dtype: Optional[str] = None
    scale: Optional[float] = None
    values: tuple = ()

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def dense_init(shape, axes, dtype: Optional[str] = None,
               scale: Optional[float] = None) -> Init:
    return Init(tuple(shape), tuple(axes), "dense", dtype, scale)


def embed_init(shape, axes) -> Init:
    return Init(tuple(shape), tuple(axes), "embed")


def const_init(shape, axes, *values: float,
               dtype: Optional[str] = None) -> Init:
    return Init(tuple(shape), tuple(axes), "const", dtype,
                values=tuple(values))


def log_arange_init(shape, axes, dtype: Optional[str] = None) -> Init:
    return Init(tuple(shape), tuple(axes), "log_arange", dtype)


def zeros_init(shape, axes, dtype: Optional[str] = None) -> Init:
    return const_init(shape, axes, 0.0, dtype=dtype)


def ones_init(shape, axes, dtype: Optional[str] = None) -> Init:
    return const_init(shape, axes, 1.0, dtype=dtype)


def draw_(p: torch.Tensor, init: Init, gen: torch.Generator) -> None:
    """Fill ``p`` in place with its initializer's distribution.

    dense: N(0, 1) * scale, scale = 1 / sqrt(fan_in) unless given, fan_in
    = shape[0] (1 for vectors); embed: N(0, 1) * 0.02; const: the blocks
    of ``init.values``; log_arange: ``log(1..N)`` along the last axis.
    Normals are drawn in float32 and then cast, as the reference does.
    """
    if init.kind in ("dense", "embed"):
        x = torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32)
        if init.kind == "embed":
            x *= 0.02
        else:
            fan_in = p.shape[0] if p.dim() >= 2 else 1
            x *= (init.scale if init.scale is not None
                  else 1.0 / math.sqrt(fan_in))
        p.copy_(x)
    elif init.kind == "const":
        for block, value in zip(p.chunk(len(init.values)), init.values):
            block.fill_(value)
    elif init.kind == "log_arange":
        n = p.shape[-1]
        p.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=p.device)).expand(p.shape))
    else:
        raise ValueError(init.kind)


class ParamTree(nn.Module):
    """A dict node of the parameter tree (children by name)."""

    def __init__(self, spec: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, node in spec.items():
            if isinstance(node, Init):
                leaf_dtype = dtype_of(node.dtype) if node.dtype else dtype
                p = nn.Parameter(torch.empty(node.shape, dtype=leaf_dtype,
                                             device=device),
                                 requires_grad=False)
                p.init = node
                self.register_parameter(name, p)
            elif isinstance(node, dict):
                self.add_module(name, ParamTree(node, dtype, device))
            elif isinstance(node, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(n, dtype, device) for n in node))
            else:
                raise TypeError(f"{name}: {type(node).__name__}")

    def __getitem__(self, name: str):
        return getattr(self, name)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "ParamTree":
        """Draw every leaf, in registration order, from ``gen``."""
        for p in self.parameters():
            draw_(p, p.init, gen)
        return self


# ---------------------------------------------------------------------------
# Bridge from the reference's parameter tree
# ---------------------------------------------------------------------------


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch's bf16
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = _to_tensor(tree)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else np.asarray(tree)[i]


def from_jax_params(cfg, tree) -> dict:
    """The reference's ``Model.init_params`` tree -> a port ``state_dict``.

    ``tree`` holds nested dicts of numpy arrays (the caller converts the
    JAX arrays with ``np.asarray``) or of torch tensors.  With
    ``cfg.scan_layers`` the ``groups`` subtree is stacked along a leading
    group axis; it is split into ``groups.<i>`` entries.  A list of groups
    is taken as it is.
    """
    groups = tree["groups"]
    if isinstance(groups, dict):
        groups = [_unstack(groups, i) for i in range(cfg.n_groups)]
    out: dict = {}
    _flatten({"embed": tree["embed"], "groups": list(groups),
              "final_norm": tree["final_norm"]}, "", out)
    return out


def _leaf_to(t: torch.Tensor, device, copy: bool = False) -> torch.Tensor:
    """``t`` on ``device``; a DTensor's full value, gathered from its mesh
    (on ``meta``: its shape alone)."""
    if isinstance(t, DTensor):
        if torch.device(device).type == "meta":
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        t = t.full_tensor()
    return t.detach().to(device, copy=copy)


def to_jax_params(cfg, sd: dict, device="cpu") -> dict:
    """A port ``state_dict`` (or a dict keyed like one) -> the reference's
    nested parameter tree, every leaf copied to ``device`` (a DTensor's
    full value).  Leaves may also be ``NamedSharding``s: a stacked one
    gains a leading replicated dim (the checkpoint layout's shardings).

    The inverse of :func:`from_jax_params`: with ``cfg.scan_layers`` the
    ``groups.<i>.<path>`` entries are stacked along a leading group axis
    into ``groups/<path>``, as the reference's scanned tree holds them;
    otherwise ``groups`` is a list of group trees.
    """
    tree: dict = {}
    per_group: list = [{} for _ in range(cfg.n_groups)]
    for key, t in sd.items():
        parts = key.split(".")
        if parts[0] == "groups":
            node, parts = per_group[int(parts[1])], parts[2:]
        else:
            node = tree
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = t

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        if isinstance(trees[0], NamedSharding):
            return NamedSharding(trees[0].mesh, P(None, *trees[0].spec))
        return torch.stack([_leaf_to(t, device) for t in trees])

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, NamedSharding):
            return node
        return _leaf_to(node, device, copy=True)

    tree = copy(tree)
    tree["groups"] = (stack(per_group) if cfg.scan_layers
                      else [copy(g) for g in per_group])
    return tree


def from_jax_state(cfg, state) -> dict:
    """The reference's train state ``{"params", "opt": {"m", "v", "step"}}``
    and, under int8 compression, ``"ef"`` (numpy arrays or torch tensors,
    DTensors too) -> the port's: ``{"params": state_dict, "opt": {"m":
    {key: t}, "v": {key: t}, "step": int32 scalar}, "ef": {key: t}}``
    with the moments keyed like the ``state_dict``."""
    opt = state["opt"]
    out = {"params": from_jax_params(cfg, state["params"]),
           "opt": {"m": from_jax_params(cfg, opt["m"]),
                   "v": from_jax_params(cfg, opt["v"]),
                   "step": _to_tensor(opt["step"]).to(torch.int32)}}
    if "ef" in state:
        out["ef"] = from_jax_params(cfg, state["ef"])
    return out


def to_jax_state(cfg, state, device="cpu") -> dict:
    """The port's train state ``{"params": Model, "opt": ..., "ef"}`` ->
    the reference's tree (groups stacked as :func:`to_jax_params` does),
    every leaf a copy on ``device``: ``cpu`` for a host snapshot, ``meta``
    for the tree's shapes alone.  On a mesh every rank calls it (a
    DTensor's full value is gathered).  The state's shardings
    (``StepBundle.in_shardings[0]``, ``params`` keyed like the
    ``state_dict``) convert alike, into the checkpoint's layout."""
    opt = state["opt"]
    params = state["params"]
    if isinstance(params, nn.Module):
        params = params.state_dict()
    step = opt["step"]
    out = {"params": to_jax_params(cfg, params, device),
           "opt": {"m": to_jax_params(cfg, opt["m"], device),
                   "v": to_jax_params(cfg, opt["v"], device),
                   "step": (step if isinstance(step, NamedSharding)
                            else _leaf_to(step, device, copy=True))}}
    if "ef" in state:
        out["ef"] = to_jax_params(cfg, state["ef"], device)
    return out
