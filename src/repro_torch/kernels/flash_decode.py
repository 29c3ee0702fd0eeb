"""Flash-decode (one query token against a KV cache) on Hopper.

Wrapper of the hand-written CUDA kernel ``csrc/flash_decode.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py``
(``_decode_kernel`` / ``flash_decode``).  The kernel source says what
bounds it on the H100 and what its design does about that.

The caches may be strided views: the model hands its (B,KV,hd,S) K cache
in as ``k_cache.permute(0, 3, 1, 2)`` without a copy, and the cache's
element type (float32 or bf16) is independent of q's.  ``pos`` is a
plain int kernel argument: one build serves every step.

A tensor on the CPU takes the plain version (:func:`ref.decode`); a CUDA
tensor launches the kernel or raises — there is no fallback.
``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # divisors of the block's 256 threads
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)

launches = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_decode")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.flash_decode.argtypes = (
            [P, P, P, P] + [I] * 8 + [L] * 8 + [F, I, F, P])
        lib.flash_decode.restype = I
        lib.flash_decode_smem_bytes.argtypes = [I, I]
        lib.flash_decode_smem_bytes.restype = L
        _lib = lib
    return _lib


def _check(q, k_cache, v_cache, pos):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("flash_decode: q must be (B, NH, hd) and the "
                         "caches (B, S, KV, hd)")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: k cache {tuple(k_cache.shape)} "
                         f"and v cache {tuple(v_cache.shape)} differ")
    B, NH, hd = q.shape
    _, S, KV, khd = k_cache.shape
    if k_cache.shape[0] != B or khd != hd or NH % KV:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k_cache.dtype not in DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; q and the caches each take "
                        "float32 or bfloat16")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    if not 0 <= pos < S:
        raise ValueError(f"flash_decode: pos {pos} outside the cache "
                         f"(S={S})")


def flash_decode(q, k_cache, v_cache, pos: int, *, scale: float,
                 window: int = 0, softcap: float = 0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd); pos: int -> (B, NH, hd)."""
    pos = int(pos)
    if q.device.type == "cpu":
        return ref.decode(q, k_cache, v_cache, pos, scale=scale,
                          window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for {q.device}")
    _check(q, k_cache, v_cache, pos)
    B, NH, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    lib = _kernel()
    smem = lib.flash_decode_smem_bytes(NH // KV, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_decode: {NH // KV} heads per KV head at "
                         f"head_dim {hd} need {smem} bytes of shared "
                         f"memory (limit {SMEM_LIMIT})")
    out = torch.empty((B, NH, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], DTYPES[k_cache.dtype],
            B, S, NH, KV, hd, pos, *k_cache.stride(), *v_cache.stride(),
            float(scale), int(window), float(softcap), stream)
    _build.check(lib, err, "flash_decode launch")
    global launches
    launches += 1
    return out
