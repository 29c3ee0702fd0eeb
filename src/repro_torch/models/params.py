"""Parameter trees as ``nn.Module``s, initializers, and the JAX bridge.

The reference builds nested dicts of arrays (``repro/models/params.py``).
Here every dict node is a :class:`ParamTree` module and every leaf an
``nn.Parameter`` (``requires_grad=False``: this slice only serves), so a
``state_dict`` key is the reference's tree path — ``groups.3.l0.mixer.wq``
— with the scanned group axis unrolled into a ``ModuleList``.  Nodes
index like dicts (``p["wq"]``), so the layer functions take a module or a
plain dict of tensors alike.

Initializers mirror ``dense_init`` / ``embed_init`` / ``zeros`` / ``ones``
(``params.py:66-81``): the same distributions, drawn from a
``torch.Generator`` on the target device.  A torch generator gives other
numbers than a JAX key, so parity tests load the reference's values with
:func:`from_jax_params` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


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
    """A leaf to be created: its shape and how it is drawn."""

    shape: tuple
    kind: str  # dense | embed | zeros | ones


def dense_init(shape) -> Init:
    return Init(tuple(shape), "dense")


def embed_init(shape) -> Init:
    return Init(tuple(shape), "embed")


def zeros_init(shape) -> Init:
    return Init(tuple(shape), "zeros")


def ones_init(shape) -> Init:
    return Init(tuple(shape), "ones")


def draw_(p: torch.Tensor, kind: str, gen: torch.Generator) -> None:
    """Fill ``p`` in place with its initializer's distribution.

    dense: N(0, 1) / sqrt(fan_in), fan_in = shape[0] (1 for vectors);
    embed: N(0, 1) * 0.02; zeros; ones.  Normals are drawn in float32 and
    then cast, as the reference does.
    """
    if kind in ("dense", "embed"):
        x = torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32)
        fan_in = p.shape[0] if p.dim() >= 2 else 1
        x *= 0.02 if kind == "embed" else 1.0 / math.sqrt(fan_in)
        p.copy_(x)
    elif kind == "zeros":
        p.zero_()
    elif kind == "ones":
        p.fill_(1.0)
    else:
        raise ValueError(kind)


class ParamTree(nn.Module):
    """A dict node of the parameter tree (children by name)."""

    def __init__(self, spec: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, node in spec.items():
            if isinstance(node, Init):
                p = nn.Parameter(torch.empty(node.shape, dtype=dtype,
                                             device=device),
                                 requires_grad=False)
                p.init_kind = node.kind
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
            draw_(p, p.init_kind, gen)
        return self


# ---------------------------------------------------------------------------
# Bridge from the reference's parameter tree
# ---------------------------------------------------------------------------


def _to_tensor(a) -> torch.Tensor:
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
    return np.asarray(tree)[i]


def from_jax_params(cfg, tree) -> dict:
    """The reference's ``Model.init_params`` tree -> a port ``state_dict``.

    ``tree`` holds nested dicts of numpy arrays (the caller converts the
    JAX arrays with ``np.asarray``).  With ``cfg.scan_layers`` the
    ``groups`` subtree is stacked along a leading group axis; it is split
    into ``groups.<i>`` entries.  A list of groups is taken as it is.
    """
    groups = tree["groups"]
    if isinstance(groups, dict):
        groups = [_unstack(groups, i) for i in range(cfg.n_groups)]
    out: dict = {}
    _flatten({"embed": tree["embed"], "groups": list(groups),
              "final_norm": tree["final_norm"]}, "", out)
    return out
