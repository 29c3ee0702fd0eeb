"""The program under test, ``repro_torch``: its configuration checked
against the configuration file, its model bound to the benchmark's
weights, and its launch counters.  The only module of the harness that
imports the port (the loops take it from here)."""
from __future__ import annotations

import importlib
import math

import torch
from torch import nn

from benchlib import weights

# the configuration file's keys and the port's ArchConfig fields they fix
_ARCH_KEYS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim_", "vocab_size": "vocab_size",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "attention_bias": "qkv_bias", "tie_word_embeddings": "tie_embeddings",
    "hidden_act": "act", "param_dtype": "param_dtype",
    "compute_dtype": "compute_dtype", "opt_dtype": "opt_dtype",
    "cache_dtype": "cache_dtype", "remat": "remat",
}


def arch_config(c: dict, arch=None):
    """The port's ``ArchConfig`` for the configuration file ``c``
    (``get_config(c["arch"])`` unless a test passes ``arch``), checked
    against every size and setting the file states: the run fails on the
    first difference rather than measure another model."""
    from repro_torch.configs import get_config
    arch = get_config(c["arch"]) if arch is None else arch
    want = {a: c[k] for k, a in _ARCH_KEYS.items()}
    got = {a: getattr(arch, a) for a in want}
    if arch.moe is not None:
        want.update(experts=c["num_local_experts"],
                    top_k=c["num_experts_per_tok"],
                    d_ff=c["intermediate_size"],
                    capacity_factor=c["capacity_factor"])
        got.update(experts=arch.moe.num_experts, top_k=arch.moe.top_k,
                   d_ff=arch.moe.d_ff,
                   capacity_factor=arch.moe.capacity_factor)
    else:
        want["d_ff"], got["d_ff"] = c["intermediate_size"], arch.d_ff
    want["gated_mlp"], got["gated_mlp"] = True, arch.gated_mlp
    want["pattern"] = "attn/moe" if arch.moe is not None else "attn/mlp"
    got["pattern"] = " ".join(f"{x.mixer}/{x.ffn}" for x in arch.pattern)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if diff:
        raise ValueError(f"{c['name']}: the port's {arch.name} differs from "
                         f"the configuration file (port, file): {diff}")
    return arch


def check_optimizer(arch, o: dict) -> None:
    """The port's optimizer (``make_opt``) against the file's."""
    from reference.plain import lr_at
    from repro_torch.train.steps import make_opt
    opt = make_opt(arch)
    oc = opt.cfg
    got = dict(lr=oc.lr, b1=oc.b1, b2=oc.b2, eps=oc.eps,
               weight_decay=oc.weight_decay, clip_norm=oc.clip_norm)
    diff = {k: (v, o[k]) for k, v in got.items() if v != o[k]}
    for step in (1, 2, 3, o["warmup_steps"] + 10):
        lr = float(opt.lr_fn(step))
        if not math.isclose(lr, lr_at(o, step), rel_tol=1e-6):
            diff[f"lr({step})"] = (lr, lr_at(o, step))
    if diff:
        raise ValueError(f"the port's optimizer differs from the "
                         f"configuration file (port, file): {diff}")


def bind_model(arch, c: dict, views: dict, *, trainable: bool = False):
    """The port's ``Model`` whose parameters are the benchmark's weights
    (no copy), after checking that the port's parameter tree is the
    benchmark's layout: the same names, shapes and dtypes."""
    from repro_torch.models import Model
    model = Model(arch, device="meta")
    params = dict(model.named_parameters())
    want = {s.name: (s.shape, weights.DTYPES[c["param_dtype"]])
            for s in weights.leaf_specs(c)}
    got = {k: (tuple(p.shape), p.dtype) for k, p in params.items()}
    if got != want:
        raise ValueError(
            f"the port's parameters differ from the benchmark's layout: "
            f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
    for key, p in params.items():
        path, _, name = key.rpartition(".")
        leaf = nn.Parameter(views[key], requires_grad=trainable)
        leaf.init = p.init
        model.get_submodule(path)._parameters[name] = leaf
    model.device = views[key].device
    return model


def cache_from(arch, layers: list) -> list:
    """The port's decode cache (one dict per group) over the benchmark's
    per-layer (K, V) tensors, checked against ``Model.init_cache``'s
    shapes, dtypes and layout on meta tensors."""
    from repro_torch.models import Model
    B, S = layers[0][0].shape[0], layers[0][0].shape[3]
    meta = Model(arch, device="meta").init_cache(B, S, layers[0][0].dtype)
    cache = [{"l0": {"mixer": {"k": k, "v": v}}} for k, v in layers]
    for m, c in zip(meta, cache, strict=True):
        for kind in ("k", "v"):
            a, b = m["l0"]["mixer"][kind], c["l0"]["mixer"][kind]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"cache layout: port {tuple(a.shape)} "
                                 f"{a.dtype}, benchmark {tuple(b.shape)} "
                                 f"{b.dtype}")
    return cache


def step_bundle(arch, name: str, seq: int, batch: int, kind: str):
    """``make_step_bundle`` without a mesh: the entry the window drives."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.train import make_step_bundle
    return make_step_bundle(arch, ShapeCfg(name, seq, batch, kind))


def make_opt_state(arch, model) -> dict:
    """The train state's optimizer part, as the train bundle's
    ``init_fn`` makes it (zero moments of ``opt_dtype``, step 0)."""
    from repro_torch.train.steps import make_opt
    return make_opt(arch).init(dict(model.named_parameters()))


def launches() -> dict:
    """The kernel wrappers' launch counters (CUDA launches only)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    return {"flash_attention": fa.launches, "flash_decode": fd.launches}


def release() -> None:
    """Give the memory of what the caller dropped back to the card."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
