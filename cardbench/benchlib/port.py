"""The program under test, ``repro_torch``: its configuration checked
against the configuration file, its model bound to the benchmark's
weights, and its launch counters.  The only module of the harness that
imports the port (the loops take it from here)."""
from __future__ import annotations

import importlib
import math

import torch
from torch import nn

from benchlib import kinds, weights

# the configuration file's keys and the port's ArchConfig fields they fix
# (each layer kind checks its own: benchlib.kinds)
_ARCH_KEYS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "hidden_act": "act",
    "param_dtype": "param_dtype", "compute_dtype": "compute_dtype",
    "opt_dtype": "opt_dtype", "cache_dtype": "cache_dtype",
    "remat": "remat",
}


def arch_config(c: dict, arch=None):
    """The port's ``ArchConfig`` for the configuration file ``c``
    (``get_config(c["arch"])`` unless a test passes ``arch``), checked
    against every size and setting the file states, its period of layer
    kinds and what each kind reads: the run fails on the first
    difference rather than measure another model."""
    from repro_torch.configs import get_config
    arch = get_config(c["arch"]) if arch is None else arch
    kinds.layers(c)         # every kind found, in its place, whole periods
    diff = {a: (getattr(arch, a), c[k]) for k, a in _ARCH_KEYS.items()}
    period = kinds.period(c)
    for name in dict.fromkeys(n for pair in period for n in pair):
        diff.update({f"{name}.{k}": v for k, v in
                     kinds.kind(name).check(c, arch).items()})
    diff["pattern"] = (" ".join(f"{x.mixer}/{x.ffn}" for x in arch.pattern),
                       " ".join(f"{m}/{f}" for m, f in period))
    diff = {k: v for k, v in diff.items() if v[0] != v[1]}
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


def cache_from(arch, c: dict, states: list, length: int) -> list:
    """The port's decode cache (one dict per group) over the benchmark's
    per-layer decode state (``layers/<kind>.py`` ``history``, in layer
    order, of ``length`` positions), checked against
    ``Model.init_cache``'s keys, shapes and dtypes on meta tensors."""
    from repro_torch.models import Model
    P = len(arch.pattern)
    cache = [{f"l{i}": {"mixer": states[g * P + i]} for i in range(P)}
             for g in range(len(states) // P)]
    rows = next(iter(states[0].values())).shape[0]
    meta = Model(arch, device="meta").init_cache(
        rows, length, weights.DTYPES[c["cache_dtype"]])

    def layout(tree):
        return [{i: {k: (tuple(t.shape), t.dtype)
                     for k, t in layer["mixer"].items()}
                 for i, layer in group.items()} for group in tree]

    if layout(meta) != layout(cache):
        raise ValueError(f"cache layout: port {layout(meta)[:1]}, "
                         f"benchmark {layout(cache)[:1]}")
    return cache


def layer_state(cache: list, layer) -> dict:
    """The decode state of ``layer`` (a ``kinds.Layer``) in the port's
    cache."""
    return cache[layer.g][f"l{layer.i}"]["mixer"]


def map_cache(cache: list, fn) -> list:
    """The port's cache with ``fn`` applied to each of its tensors."""
    return [{i: {"mixer": {k: fn(t) for k, t in layer["mixer"].items()}}
             for i, layer in group.items()} for group in cache]


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


def launches(names) -> dict:
    """The launch counters (CUDA launches only) of the kernel wrappers
    ``repro_torch.kernels.<name>`` for each of ``names``."""
    return {k: importlib.import_module(f"repro_torch.kernels.{k}").launches
            for k in names}


def release() -> None:
    """Give the memory of what the caller dropped back to the card."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
