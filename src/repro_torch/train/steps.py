"""The train step: loss, gradients (optionally over microbatches), AdamW.

Counterpart of ``repro/train/steps.py`` on one device.
``make_step_bundle(cfg, shape)`` returns the ``train_step(state, batch)``
and the ``init_fn(generator)`` that makes its state,
``{"params": Model, "opt": AdamW state}``.  The step updates the state in
place and returns it with ``{"loss", "step"}``.

Microbatching follows the reference's ``accumulate``: the gradients of
``cfg.microbatches`` slices of the batch are summed in float32 buffers
(not in the parameters' ``.grad``, which would sum in their dtype) and
divided by their count; the loss is the mean of the slices' losses.
With one microbatch the gradients keep the parameters' dtype.

Not ported yet: meshes, shardings and int8 gradient compression
(ROADMAP A11); the prefill and decode bundles and the input specs of the
dry run (ROADMAP A12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import Model
from repro_torch.optim import AdamW, OptConfig, cosine_warmup


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
    mesh: None
    step_fn: Callable            # train_step(state, batch)
    init_fn: Optional[Callable] = None   # init_fn(generator) -> state


def make_opt(cfg: ArchConfig, total_steps: int = 100_000) -> AdamW:
    oc = OptConfig(state_dtype=cfg.opt_dtype)
    return AdamW(oc, cosine_warmup(oc.lr, 2_000, total_steps))


def make_step_bundle(cfg: ArchConfig, shape: ShapeCfg,
                     mesh=None) -> StepBundle:
    if mesh is not None:
        raise NotImplementedError("meshes and shardings are not ported to "
                                  "repro_torch yet (ROADMAP A11)")
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind!r} step bundles are not "
                                  "ported to repro_torch yet (ROADMAP A12)")
    return _train_bundle(cfg, shape)


def load_state(state: dict, tree: dict) -> None:
    """Copy a port-form state (``models.params.from_jax_state``) into
    ``state`` in place: parameters, both moments and the step."""
    state["params"].load_state_dict(tree["params"])
    opt = state["opt"]
    for part in ("m", "v"):
        for k, t in opt[part].items():
            t.copy_(tree["opt"][part][k])
    opt["step"].copy_(tree["opt"]["step"])


def _train_bundle(cfg: ArchConfig, shape: ShapeCfg) -> StepBundle:
    opt = make_opt(cfg)

    def grads_of(model, batch):
        params = dict(model.named_parameters())
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads)), loss.detach(), metrics

    def accumulate(model, batch):
        k = cfg.microbatches
        if k <= 1:
            return grads_of(model, batch)
        B = batch["labels"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{k} microbatches")
        n = B // k
        gsum = {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in model.named_parameters()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=batch["labels"].device)
        for i in range(k):
            g, loss, _ = grads_of(
                model, {key: t[i * n:(i + 1) * n] for key, t in batch.items()})
            for name, gi in g.items():
                gsum[name].add_(gi.float())
            lsum = lsum + loss
        return {name: g / k for name, g in gsum.items()}, lsum / k, {}

    def train_step(state, batch):
        model = state["params"]
        grads, loss, _ = accumulate(model, batch)
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
