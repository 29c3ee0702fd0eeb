"""int8 gradient compression with error feedback for the cross-pod average.

Counterpart of ``repro/optim/compress.py``.  Across the ``pod`` axis,
gradients are quantized to int8 with a per-tensor scale, exchanged with
``all_gather`` (the wire carries int8 and one float32 scale per tensor),
dequantized and averaged locally.  The quantization error is carried in an
error-feedback buffer and added to the next step's gradient (Karimireddy
et al., 2019).  Reductions within a pod stay uncompressed.

``quantize_int8`` and ``dequantize_int8`` are bitwise the reference's:
the same float32 operations in the same order, and ``torch.round`` rounds
half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_init(grads):
    """Zero float32 error-feedback buffers shaped like the gradient tree (a
    tensor, or dicts and lists of them)."""
    if isinstance(grads, dict):
        return {k: ef_init(g) for k, g in grads.items()}
    if isinstance(grads, list):
        return [ef_init(g) for g in grads]
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in group-rank order."""
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape((1,) + tuple(t.shape)),
                                group=group)
    return out


def compressed_pod_allreduce(grads, ef, group=None):
    """Average per-pod gradients over ``group`` (the mesh's ``pod`` group,
    one rank per pod; None or a group of one: a single pod) in int8.

    grads: this pod's gradient tree (already averaged within the pod; a
    tensor, or dicts and lists of them), each leaf quantized with its own
    scale, so a tree in the reference's layout (groups stacked) quantizes
    as the reference does; ef: the error-feedback tree of the last step.
    Returns (averaged gradients in each gradient's dtype, new error
    feedback).  The mean is ``sum_i scale_i * q_i / n`` in float32, summed
    in rank order.
    """
    if isinstance(grads, (dict, list)):
        keys = grads.keys() if isinstance(grads, dict) else range(len(grads))
        out = {k: compressed_pod_allreduce(grads[k], ef[k], group)
               for k in keys}
        if isinstance(grads, dict):
            return ({k: a for k, (a, _) in out.items()},
                    {k: e for k, (_, e) in out.items()})
        return [out[k][0] for k in keys], [out[k][1] for k in keys]
    n = 1 if group is None else dist.get_world_size(group)
    g32 = grads.float() + ef
    q, scale = quantize_int8(g32)
    new_ef = g32 - dequantize_int8(q, scale)
    if n == 1:
        qs, scales = q[None], scale[None]
    else:
        qs, scales = _all_gather(q, group, n), _all_gather(scale, group, n)
    deq = scales[0] * qs[0].float()
    for i in range(1, n):
        deq = deq + scales[i] * qs[i].float()
    return (deq / n).to(grads.dtype), new_ef
