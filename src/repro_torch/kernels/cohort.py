"""Cohort-delivery arithmetic (numpy only).

The fused fetch path (``core/broker.py``, ``fetch_mode="fused"``)
coalesces the per-partition deliver events of one fetch cycle into
cohort events and answers the cross-view bookkeeping with vectorized
integer/float passes.  The pure arithmetic lives here so the broker and
the window operators share one bit-exactness argument.

Float64 element-wise IEEE ops only: ``pane_starts`` is bitwise
identical to the scalar composition ``float(math.floor(et / w)) * w`` —
``np.floor`` and ``math.floor`` agree on every finite float64 and the
divide / multiply are the same IEEE ops.  This is the fingerprint-safe
backend; a float64 torch backend is future work (ROADMAP A8b).
"""
from __future__ import annotations

import math

import numpy as np

# below this cohort size the python loop beats the asarray round trip;
# both paths produce identical results (integer comparisons only)
_SMALL = 32


def pane_start(et: float, size_s: float) -> float:
    """Scalar tumbling-pane start for one event time (reference)."""
    return float(math.floor(et / size_s)) * size_s


def pane_starts(event_times, size_s: float) -> np.ndarray:
    """Vectorized tumbling-window pane assignment for a row cohort.

    One ``floor`` pass computes every pane start; bit-identical to
    :func:`pane_start` per element, so pane dict keys match the scalar
    per-record path exactly (asserted in ``tests/test_fused_fetch.py``).
    """
    return (np.floor(np.asarray(event_times, np.float64) / size_s)
            * size_s)


def group_spans(values) -> list:
    """Boundaries ``[(lo, hi), ...]`` of consecutive equal-value runs.

    The fused fetch groups same-landing-time responses with this: the
    per-partition ``t_land`` sequence is non-decreasing (each value is
    maxed with the connection's previous in-flight horizon), so equal
    values always form consecutive runs and each run becomes one cohort
    deliver event.  Comparisons are exact float equality — no epsilon,
    ties only exist where the *same* float expression was reused.
    """
    m = len(values)
    if m == 0:
        return []
    if m < _SMALL:
        spans = []
        lo = 0
        prev = values[0]
        for i in range(1, m):
            v = values[i]
            if v != prev:
                spans.append((lo, i))
                lo = i
                prev = v
        spans.append((lo, m))
        return spans
    arr = np.asarray(values, np.float64)
    cuts = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    edges = [0, *cuts.tolist(), m]
    return list(zip(edges[:-1], edges[1:]))


def int_tallies(keys, amounts) -> dict:
    """Per-key integer sums over a cohort (python ints — associative,
    so batching is always fingerprint-safe, unlike float reductions
    which must stay per-view; see the ROADMAP cohort contract)."""
    out: dict = {}
    for k, a in zip(keys, amounts):
        out[k] = out.get(k, 0) + a
    return out
