"""Flash-attention forward (GQA, causal, window, softcap) on Hopper.

Wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``,
which replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_fwd_kernel`` / ``flash_attention_fwd``).  The kernel source says
what bounds it on the H100 and what its design does about that.

A tensor on the CPU takes the plain version (:func:`ref.attention`); a
CUDA tensor launches the kernel or raises — there is no fallback.
``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.flash_attention_fwd.argtypes = (
            [P, P, P, P] + [I] * 7 + [L] * 12 + [F, I, I, F, P])
        lib.flash_attention_fwd.restype = I
        _lib = lib
    return _lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D "
                         "(B, S, heads, head_dim)")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    B, _, NH, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if NH % k.shape[2]:
        raise ValueError(f"flash_attention: {NH} query heads over "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of float32, "
                        "bfloat16 for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} head_dim stride "
                             f"{t.stride(3)} != 1")


def _rows_aligned(t) -> bool:
    """Every (batch, seq, head) row of t starts 16-byte aligned."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * e % 16 == 0 for i in range(3))


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, NH, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, NH, hd)."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        # the tensor-core path copies 16-byte runs of each row
        q, k, v = (t if _rows_aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    B, Sq, NH, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, NH, hd), dtype=q.dtype, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, Sq, Sk, NH, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), int(bool(causal)), int(window), float(softcap),
            stream)
    _build.check(lib, err, "flash_attention launch")
    global launches
    launches += 1
    return out
