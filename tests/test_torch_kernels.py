"""The port's attention kernels and their plain versions against the JAX
package: the same numpy inputs go through ``repro.kernels`` (the jnp
oracle, and the Pallas kernel in interpret mode) and
``repro_torch.kernels`` (on the CPU a wrapper takes the plain torch
version).  Tolerances are those of ``tests/test_kernels.py``: float32
atol = rtol = 2e-5, bfloat16 2e-2.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, ref

# the kernel modules (their launch counters): the package names resolve to
# ops's callables
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fd = importlib.import_module("repro_torch.kernels.flash_decode")

FWD_CASES = [
    # B, S, NH, KV, hd, window, softcap
    (2, 64, 4, 4, 32, 0, 0.0),       # MHA
    (2, 128, 8, 2, 64, 0, 0.0),      # GQA 4:1
    (1, 256, 8, 1, 64, 0, 0.0),      # MQA
    (1, 128, 4, 2, 32, 32, 0.0),     # sliding window
    (1, 128, 4, 2, 32, 0, 50.0),     # softcap (gemma2)
    (1, 96, 2, 2, 16, 24, 30.0),     # window + softcap, odd sizes
]

DECODE_CASES = [
    # B, S, NH, KV, hd, pos, window, softcap
    (2, 128, 4, 4, 32, 64, 0, 0.0),
    (2, 256, 8, 2, 64, 255, 0, 0.0),
    (1, 512, 8, 1, 64, 0, 0, 0.0),      # pos=0: single valid key
    (1, 256, 4, 2, 32, 200, 64, 0.0),   # window
    (1, 128, 4, 4, 32, 100, 0, 50.0),   # softcap
]

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def both(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def close(port, want, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attention_matches_jax(case, dtype):
    B, S, NH, KV, hd, window, cap = case
    qa, ka, va = arrays(sum(case[:5]), (B, S, NH, hd), (B, S, KV, hd),
                        (B, S, KV, hd))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qa, ka, va))
    scale = hd ** -0.5
    tol = DTYPES[dtype][2]
    before = fa.launches
    port = ops.flash_attention(qt, kt, vt, scale, True, window, cap)
    assert fa.launches == before, "a CPU tensor must not count a launch"
    assert port.dtype == qt.dtype and port.shape == qt.shape
    close(port, jref.attention(qj, kj, vj, scale=scale, causal=True,
                               window=window, softcap=cap), tol)
    close(port, jops.flash_attention(qj, kj, vj, scale, True, window, cap),
          tol)
    close(ref.attention(qt, kt, vt, scale=scale, causal=True, window=window,
                        softcap=cap),
          jref.attention(qj, kj, vj, scale=scale, causal=True,
                         window=window, softcap=cap), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_matches_jax(case, dtype):
    B, S, NH, KV, hd, pos, window, cap = case
    qa, ka, va = arrays(sum(case[:5]), (B, NH, hd), (B, S, KV, hd),
                        (B, S, KV, hd))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (qa, ka, va))
    scale = hd ** -0.5
    tol = DTYPES[dtype][2]
    before = fd.launches
    port = ops.flash_decode(qt, kt, vt, pos, scale=scale, window=window,
                            softcap=cap)
    assert fd.launches == before, "a CPU tensor must not count a launch"
    close(port, jref.decode(qj, kj, vj, pos, scale=scale, window=window,
                            softcap=cap), tol)
    close(port, jops.flash_decode(qj, kj, vj, pos, scale=scale,
                                  window=window, softcap=cap), tol)


def test_decode_reads_strided_cache_views():
    """The model's (B,KV,hd,S) K cache, permuted to (B,S,KV,hd) without a
    copy, and a float32 cache under a bf16 q, give the oracle's answer."""
    B, S, NH, KV, hd, pos = 2, 40, 6, 2, 32, 29
    qa, ka, va = arrays(7, (B, NH, hd), (B, KV, hd, S), (B, KV, S, hd))
    q = torch.from_numpy(qa).to(torch.bfloat16)
    kc = torch.from_numpy(ka).permute(0, 3, 1, 2)
    vc = torch.from_numpy(va).permute(0, 2, 1, 3)
    assert not kc.is_contiguous()
    want = jref.decode(jnp.asarray(qa, jnp.bfloat16),
                       jnp.asarray(np.transpose(ka, (0, 3, 1, 2))),
                       jnp.asarray(np.transpose(va, (0, 2, 1, 3))), pos,
                       scale=hd ** -0.5)
    close(ops.flash_decode(q, kc, vc, pos, scale=hd ** -0.5), want, 2e-2)


@pytest.mark.parametrize("zc", [False, True])
def test_rmsnorm_oracle_matches_jax(zc):
    xa, sa = arrays(3, (2, 5, 48), (48,))
    close(ref.rmsnorm(torch.from_numpy(xa), torch.from_numpy(sa),
                      zero_centered=zc),
          jref.rmsnorm(jnp.asarray(xa), jnp.asarray(sa), zero_centered=zc),
          2e-5)


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1], 0.25)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_decode(q[:, 0], q[:, :, :1], q[:, :, :1], 0, scale=0.25)
