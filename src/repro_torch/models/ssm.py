"""Pieces of the Mamba-1 selective SSM block (``repro/models/ssm.py``).

Only :func:`_causal_conv` is ported so far: the mLSTM block uses it
(``repro/models/xlstm.py:161``).  ``selective_scan``, ``mamba_apply`` and
the mamba cache, which jamba needs, come with ROADMAP A9.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _causal_conv(x, w, b, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B,S,di), w: (K,di).  cache: (B,K-1,di).

    Returns (out, new_cache); new_cache is None without a cache, else the
    last K-1 inputs (cache included) in ``x``'s dtype.
    """
    K = w.shape[0]
    if cache is not None:
        x_pad = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = x_pad[:, -(K - 1):] if K > 1 else cache
    else:
        x_pad = F.pad(x, (0, 0, K - 1, 0))
        new_cache = None
    S = x.shape[1]
    out = sum(x_pad[:, i:i + S] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :], new_cache
