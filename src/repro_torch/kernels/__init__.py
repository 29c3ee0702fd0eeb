"""Kernel package: hand-written CUDA attention kernels + numpy net arithmetic.

The attention modules (``ops``/``ref``/``flash_attention``/
``flash_decode``) import torch, so they are exposed lazily:
``repro_torch.kernels.netcalc`` and ``repro_torch.kernels.cohort`` (used
by the deterministic emulator hot path) import without torch — the
warm-pool contract of the reference.  No module builds a kernel when it
is imported: ``_build`` compiles at first launch.
"""
import importlib

from repro_torch.kernels import cohort, netcalc

__all__ = ["cohort", "netcalc", "ops", "ref", "flash_attention",
           "flash_decode"]


def __getattr__(name):
    if name in ("ops", "ref", "flash_attention", "flash_decode"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
