"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out from the same inputs."""
from __future__ import annotations

import math
import statistics

import torch


def rel(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref)


def leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    """Each leaf's gap of norms, |prog - ref|, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    out = []
    for k in leaves:
        gap, den = abs(prog[k] - ref[k]), max(ref[k], med)
        out.append(gap / den if den > 0 else
                   (0.0 if gap == 0 else math.inf))
    return out


def worst_leaf(prog: dict, ref: dict, leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves))


def median_leaf(prog: dict, ref: dict, leaves) -> float:
    return statistics.median(leaf_gaps(prog, ref, leaves))


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the root mean square of b (b the reference)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.pow(2).mean().sqrt())


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best at that position: ref_logits (..., V), tokens
    (...)."""
    best = ref_logits.max(-1).values
    chosen = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return float((best - chosen).max())
