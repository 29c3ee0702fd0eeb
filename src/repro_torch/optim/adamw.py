"""AdamW over a parameter dict with dtype-configurable state.

Counterpart of ``repro/optim/adamw.py``, with its arithmetic in its
order: the global-norm clip in float32, cast back to each gradient's
dtype; bias corrections from a float32 step; the update in float32 with
``delta + weight_decay * p32`` on every leaf; the parameter cast back to
its dtype and the moments to ``state_dtype`` (``ArchConfig.opt_dtype``).
``torch.optim.AdamW`` is not used: its moments take the parameter's
dtype, and it places the decay and epsilon otherwise.

Parameters, gradients and moments are dicts keyed alike (the model's
``state_dict`` keys).  ``update`` writes the parameters and the moments
in place, one leaf at a time, so the float32 temporaries of only one
leaf are alive at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.models.params import dtype_of


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x**2), in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """Returns (clipped tree, norm); each leaf scaled in float32 and cast
    back to its dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


class AdamW:
    def __init__(self, cfg: OptConfig,
                 lr_fn: Optional[Callable] = None) -> None:
        self.cfg = cfg
        self.lr_fn = lr_fn or (lambda step: cfg.lr)

    def init(self, params: dict) -> dict:
        """Zero moments in ``state_dtype``, keyed like ``params``, on each
        parameter's device; ``step`` an int32 scalar."""
        dt = dtype_of(self.cfg.state_dtype)
        dev = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict):
        """Updates ``params`` and ``opt_state`` in place; returns both."""
        c = self.cfg
        step = opt_state["step"] + 1
        if c.clip_norm:
            scale = _clip_scale(global_norm(grads), c.clip_norm)
        stepf = step.float()
        bc1 = 1.0 - c.b1 ** stepf
        bc2 = 1.0 - c.b2 ** stepf
        lr = self.lr_fn(step)
        for key, p in params.items():
            g = grads[key]
            if c.clip_norm:
                g = (g.float() * scale).to(g.dtype)
            g32 = g.float()
            m, v = opt_state["m"][key], opt_state["v"][key]
            # .float() of a float32 moment is the moment itself: these
            # update it in place
            m32 = m.float().mul_(c.b1).add_((1 - c.b1) * g32)
            v32 = v.float().mul_(c.b2).add_((1 - c.b2) * g32 * g32)
            delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(c.eps))
            p32 = p.float()
            p32.sub_(delta.add_(c.weight_decay * p32).mul_(lr))
            for dst, src in ((p, p32), (m, m32), (v, v32)):
                if dst is not src:
                    dst.copy_(src)
        opt_state["step"] = step
        return params, opt_state
