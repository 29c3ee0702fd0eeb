"""Delay/bandwidth arithmetic for the network model (numpy only).

The inner loop of :meth:`repro_torch.core.netem.Network.transfer` —
propagation latency plus serialization at the bottleneck link — lives
here so cohort fusion (``transfer_many``) runs it as one vectorized
computation.

Float64 element-wise IEEE ops only (the fingerprint-safe backend),
bitwise identical to the scalar composition in the on-demand hop walk
(``lat + nbytes / bw``; ``x / inf == 0.0`` reproduces the ``bw < inf``
serialization guard exactly).  A float64 torch backend is future work
(ROADMAP A8b).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def delay_s(lat_s: float, bneck_Bps: float, nbytes: int) -> float:
    """Scalar transfer delay: latency + serialization at the bottleneck.

    Bitwise identical to the on-demand composition
    ``lat + (nbytes / bw if bw < inf else 0.0)``: division by ``inf``
    yields exactly ``0.0`` and ``lat + 0.0 == lat`` for the nonnegative
    latencies the model produces.
    """
    return lat_s + nbytes / bneck_Bps


def delay_many(lat_s: np.ndarray, bneck_Bps: np.ndarray, nbytes: int,
               extra_s: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized cohort delay: one fused computation for a homogeneous
    (same payload size) fan-out.  ``extra_s`` carries per-destination
    slow-host extras, pre-summed with the source's (matching the scalar
    ``delay += (src_extra + dst_extra)`` association)."""
    out = lat_s + nbytes / bneck_Bps
    if extra_s is not None:
        out = out + extra_s
    return out
