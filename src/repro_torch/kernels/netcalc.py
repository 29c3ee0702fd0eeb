"""Delay/bandwidth arithmetic for the network model (numpy first, an
opt-in torch backend).

The inner loop of :meth:`repro_torch.core.netem.Network.transfer` —
propagation latency plus serialization at the bottleneck link — lives
here so cohort fusion (``transfer_many``) runs it as one vectorized
computation.

Backends of :func:`delay_many`, chosen by ``REPRO_NETCALC_BACKEND``:

- ``numpy`` (the default, and any value that does not start with
  ``torch``): float64 element-wise IEEE ops, bitwise identical to the
  scalar composition in the on-demand hop walk (``lat + nbytes / bw``;
  ``x / inf == 0.0`` reproduces the ``bw < inf`` serialization guard
  exactly).
- ``torch`` (on ``cuda``; raises without a GPU) and ``torch:cpu``: the
  same ops on ``torch.float64`` tensors in the same association, so the
  result is bit-identical to numpy's (IEEE ``/`` and ``+`` are correctly
  rounded on the CPU and the GPU; the division is a true division of two
  tensors on one device, not torch's ``scalar / tensor``, which
  multiplies by a reciprocal).  torch is imported inside the switch,
  never at module scope.  Any other value starting with ``torch``
  raises; nothing falls back to another device or dtype.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.kernels.cohort import torch_device


def delay_s(lat_s: float, bneck_Bps: float, nbytes: int) -> float:
    """Scalar transfer delay: latency + serialization at the bottleneck.

    Bitwise identical to the on-demand composition
    ``lat + (nbytes / bw if bw < inf else 0.0)``: division by ``inf``
    yields exactly ``0.0`` and ``lat + 0.0 == lat`` for the nonnegative
    latencies the model produces.
    """
    return lat_s + nbytes / bneck_Bps


def _delay_many_np(lat_s: np.ndarray, bneck_Bps: np.ndarray, nbytes: int,
                   extra_s: Optional[np.ndarray]) -> np.ndarray:
    out = lat_s + nbytes / bneck_Bps
    if extra_s is not None:
        out = out + extra_s
    return out


def _delay_many_torch(lat_s, bneck_Bps, nbytes: int, extra_s,
                      backend: str = "torch") -> np.ndarray:
    import torch
    dev = torch_device(backend)

    def f64(a):
        return torch.tensor(np.asarray(a, np.float64), device=dev)

    bw = f64(bneck_Bps)
    num = torch.tensor(float(nbytes), dtype=torch.float64, device=dev)
    out = f64(lat_s) + torch.div(num, bw)
    if extra_s is not None:
        out = out + f64(extra_s)
    return out.cpu().numpy()


def delay_many(lat_s: np.ndarray, bneck_Bps: np.ndarray, nbytes: int,
               extra_s: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized cohort delay: one fused computation for a homogeneous
    (same payload size) fan-out.  ``extra_s`` carries per-destination
    slow-host extras, pre-summed with the source's (matching the scalar
    ``delay += (src_extra + dst_extra)`` association)."""
    backend = os.environ.get("REPRO_NETCALC_BACKEND", "numpy")
    if backend.startswith("torch"):
        return _delay_many_torch(lat_s, bneck_Bps, nbytes, extra_s, backend)
    return _delay_many_np(lat_s, bneck_Bps, nbytes, extra_s)
