"""Flash-decode (one query token against a KV cache) on Hopper.

Wrapper of the hand-written CUDA kernel ``csrc/flash_decode.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py``
(``_decode_kernel`` / ``flash_decode``).  The kernel source says what
bounds it on the H100 and what its design does about that.

The caches may be strided views: the model hands its (B,KV,hd,S) K cache
in as ``k_cache.permute(0, 3, 1, 2)`` without a copy, and the cache's
element type (float32 or bf16) is independent of q's.  The valid keys
are plain int kernel arguments: one build serves every step.  The
wrapper splits them over several blocks per (batch row, KV head) when
the grid would leave the card idle (:func:`split_count`).

A tensor on the CPU takes the plain version (:func:`ref.decode`); a CUDA
tensor launches the kernel or raises — there is no fallback.
``launches`` counts wrapper calls that launch the kernel (the split
kernel, and the combine kernel after it when the cache is split);
plain-version calls do not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)

# split rule (split_count)
MIN_SPLIT_UNITS = 2  # units of ref.SPLIT_KEYS keys that a split must get
MAX_SPLIT = 64       # (csrc/flash_decode.cu MAX_SPLIT)

launches = 0

_lib = None
_occupancy: dict = {}  # (G, hd, kv dtype, K layout) -> blocks per SM
_sms: dict = {}        # device index -> SM count


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_decode")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.flash_decode.argtypes = (
            [P] * 5 + [I] * 9 + [L] * 8 + [I] * 3 + [F, F, P])
        lib.flash_decode.restype = I
        lib.flash_decode_occupancy.argtypes = [I, I, I, I, P, P]
        lib.flash_decode_occupancy.restype = I
        _lib = lib
    return _lib


def split_count(ctas: int, lo: int, hi: int, slots: int) -> int:
    """How many splits the keys [lo, hi) get.

    ``ctas`` blocks (batch x KV heads) run without a split and ``slots``
    blocks fit on the card at once (SMs x blocks per SM).  The rule: fill
    at most one wave (n x ctas <= slots), give every split at least
    MIN_SPLIT_UNITS units of ``ref.SPLIT_KEYS`` keys (below 256 keys a
    split saves less than the combine launch costs), never more than
    MAX_SPLIT; and 1 when that leaves less than 2.  Splits are never
    empty, and with n = 1 no combine kernel launches.  At the main path's
    decode (keys 0..64-70, B=4 x KV=4 blocks) it gives 1.
    """
    n = min(slots // max(ctas, 1),
            ref.split_units(lo, hi) // MIN_SPLIT_UNITS, MAX_SPLIT)
    return max(1, n)


def _blocks_per_sm(lib, G, hd, kv_dtype, kseq) -> int:
    key = (G, hd, kv_dtype, kseq)
    n = _occupancy.get(key)
    if n is None:
        smem, n_c = ctypes.c_longlong(), ctypes.c_int()
        err = lib.flash_decode_occupancy(G, hd, DTYPES[kv_dtype], int(kseq),
                                         ctypes.byref(smem),
                                         ctypes.byref(n_c))
        n = n_c.value
        if err != 0 or n < 1:
            raise ValueError(f"flash_decode: {G} heads per KV head at "
                             f"head_dim {hd} ({kv_dtype} cache) need "
                             f"{smem.value} bytes of shared memory per "
                             "block, more than the card gives one block")
        _occupancy[key] = n
    return n


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _k_seq_major(k_cache) -> bool:
    """K is read with its seq axis at unit stride (the model's layout)."""
    return k_cache.stride(1) == 1 and k_cache.stride(3) != 1


def _vec_ok(t, unit_dim: int) -> bool:
    """16-byte copies along ``unit_dim`` are allowed: unit stride there,
    and every run along it starts 16-byte aligned."""
    e = t.element_size()
    return (t.stride(unit_dim) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * e % 16 == 0 for i in range(4)
                    if i != unit_dim))


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


def _auto_split(lib, q, k_cache, lo: int, hi: int, kseq: bool) -> int:
    B, NH, hd = q.shape
    KV = k_cache.shape[2]
    bps = _blocks_per_sm(lib, NH // KV, hd, k_cache.dtype, kseq)
    return split_count(B * KV, lo, hi, _sm_count(q.device) * bps)


def plan(q, k_cache, pos: int, window: int = 0) -> int:
    """The split count :func:`flash_decode` takes for these inputs on the
    card (builds the kernel on first use)."""
    return _auto_split(_kernel(), q, k_cache,
                       *ref.valid_range(int(pos), window),
                       _k_seq_major(k_cache))


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
    KV = k_cache.shape[2]
    lo, hi = ref.valid_range(pos, window)
    kseq = _k_seq_major(k_cache)
    lib = _kernel()
    n_split = _auto_split(lib, q, k_cache, lo, hi, kseq)
    out = torch.empty((B, NH, hd), dtype=q.dtype, device=q.device)
    part = out if n_split == 1 else torch.empty(
        n_split * B * NH * (hd + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part.data_ptr(), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], B, NH, KV, hd, lo, hi, n_split,
            *k_cache.stride(), *v_cache.stride(), int(kseq),
            int(_vec_ok(k_cache, 1 if kseq else 3)), int(_vec_ok(v_cache, 3)),
            float(scale), float(softcap), stream)
    _build.check(lib, err, "flash_decode launch")
    global launches
    launches += 1
    return out
