"""Kernel package: hand-written CUDA attention kernels + numpy net arithmetic.

The attention modules (``ops``/``ref``/``flash_attention``/
``flash_decode``) import torch, so they are exposed lazily:
``repro_torch.kernels.netcalc`` and ``repro_torch.kernels.cohort`` (used
by the deterministic emulator hot path) import without torch — the
warm-pool contract of the reference.  No module builds a kernel when it
is imported: ``_build`` compiles at first launch.

As in the reference, the package names ``flash_attention`` and
``flash_decode`` resolve to ``ops``'s callables when first asked for;
importing ``ops`` imports the kernel modules of the same names, which
sets the package attribute of any name not yet resolved to its module.
Code that needs a kernel module (its launch counter) takes it with
``importlib.import_module("repro_torch.kernels.flash_attention")``.
"""
import importlib

from repro_torch.kernels import cohort, netcalc

__all__ = ["cohort", "netcalc", "ops", "ref", "flash_attention",
           "flash_decode"]


def __getattr__(name):
    if name in ("ops", "ref"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        globals()[name] = mod
        return mod
    if name in ("flash_attention", "flash_decode"):
        fn = getattr(importlib.import_module("repro_torch.kernels.ops"), name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
