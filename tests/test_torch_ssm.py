"""The port's Mamba-1 selective SSM against the JAX package's.

Same numpy inputs and parameters through ``repro.models.ssm`` and
``repro_torch.models.ssm`` in float32.  ``selective_scan`` runs at S=64
(one chunk) and S=256 (two chunks of 128, the reference's ``lax.scan``
branch), with and without an initial state; ``mamba_apply`` runs a
prefill from a fresh cache, then decode steps from that cache.

The port's in-chunk scan is a Hillis-Steele scan, the reference's a
``jax.lax.associative_scan``: the same recurrence, associated
differently, so they round differently.  Tolerance: float32 atol = rtol
= 2e-5 (the single-layer bar of ``tests/test_torch_models.py``);
gradients at rtol 1e-4 with atol 1e-4 times the largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.models import ssm as jssm
from repro.models.params import unzip
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import ssm
from repro_torch.models.params import ParamTree

TOL = 2e-5


def close(port, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def scan_inputs(S, seed=0, B=2, di=24, N=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, di)).astype(np.float32)
    # softplus-range steps, as mamba_apply feeds the scan
    dt = np.log1p(np.exp(rng.normal(-1, 1, (B, S, di)))).astype(np.float32)
    Bc, Cc = (rng.normal(0, 1, (B, S, N)).astype(np.float32)
              for _ in range(2))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    D = rng.normal(1, 0.1, (di,)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, di, N)).astype(np.float32)
    return x, dt, Bc, Cc, A, D, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 64, 256])
def test_selective_scan_matches_reference(S, with_h0):
    x, dt, Bc, Cc, A, D, h0 = scan_inputs(S)
    h0 = h0 if with_h0 else None
    jy, jh = jssm.selective_scan(
        *map(jnp.asarray, (x, dt, Bc, Cc, A, D)),
        h0=None if h0 is None else jnp.asarray(h0))
    y, h = ssm.selective_scan(
        *map(torch.from_numpy, (x, dt, Bc, Cc, A, D)),
        h0=None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and h.shape == (2, 24, 8)
    close(y, jy)
    close(h, jh)


def test_scan_chunk_matches_sequential_recurrence():
    """The Hillis-Steele scan at a chunk length that is not a power of
    two, against h_t = a_t h_{t-1} + b_t in float64."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (2, 37, 3, 4))
    b = rng.normal(0, 1, (2, 37, 3, 4))
    h0 = rng.normal(0, 1, (2, 3, 4))
    h, want = h0, []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got, last = ssm._scan_chunk(*map(torch.from_numpy, (h0, a, b)))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(last.numpy(), want[-1], rtol=1e-12,
                               atol=1e-12)


def test_selective_scan_grads_match_reference():
    x, dt, Bc, Cc, A, D, h0 = scan_inputs(256, seed=2)
    g = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)

    def jf(*args):
        y, h = jssm.selective_scan(*args[:6], h0=args[6])
        return jnp.sum(y * g) + jnp.sum(h)

    args = (x, dt, Bc, Cc, A, D, h0)
    want = jax.grad(jf, argnums=tuple(range(7)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ssm.selective_scan(*ts[:6], h0=ts[6])
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(g))
                              + torch.sum(h), ts)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4 * scale, rtol=1e-4)


def mamba_cfgs():
    jcfg = jreduce(jget("jamba-v0.1-52b"))
    cfg = reduce_for_smoke(get_config("jamba-v0.1-52b"))
    return jcfg, cfg


def mamba_params(cfg, seed=0):
    """The reference's initializer values, with random conv bias, dt
    bias and A_log so that no term is trivially zero."""
    vals = jax.tree.map(np.asarray, unzip(jssm.init_mamba(
        jax.random.key(seed), jreduce(jget("jamba-v0.1-52b"))))[0])
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias"):
        vals[k] = rng.normal(0, 0.5, vals[k].shape).astype(np.float32)
    vals["A_log"] = vals["A_log"] + rng.normal(
        0, 0.1, vals["A_log"].shape).astype(np.float32)
    return vals


@pytest.mark.parametrize("S", [16, 256])
def test_mamba_prefill_and_decode_match_reference(S):
    """A prefill from a fresh cache (the conv tail and the last state come
    back), then 3 decode steps from that cache."""
    jcfg, cfg = mamba_cfgs()
    p = mamba_params(cfg)
    assert p["A_log"].dtype == p["D"].dtype == np.float32
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jout, jc = jssm.mamba_apply(jp, jnp.asarray(x), jcfg,
                                cache=jssm.init_mamba_cache(jcfg, 2,
                                                            jnp.float32))
    out, c = ssm.mamba_apply(tp, torch.from_numpy(x), cfg,
                             cache=ssm.init_mamba_cache(cfg, 2,
                                                        torch.float32))
    close(out, jout, 1e-4)
    close(c["conv"], jc["conv"])
    close(c["ssm"], jc["ssm"], 1e-4)
    # no cache: the same output, no state
    out2, none = ssm.mamba_apply(tp, torch.from_numpy(x), cfg)
    assert none is None
    close(out2, jout, 1e-4)
    for step in range(3):
        x1 = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
        jout, jc = jssm.mamba_apply(jp, jnp.asarray(x1), jcfg, cache=jc)
        out, c = ssm.mamba_apply(tp, torch.from_numpy(x1), cfg, cache=c)
        close(out, jout, 1e-4)
        close(c["conv"], jc["conv"])
        close(c["ssm"], jc["ssm"], 1e-4)


def test_init_mamba_matches_reference_leaves():
    """Shapes, dtypes (A_log and D float32 in a bf16 tree) and the
    deterministic leaves of the init; A_log = log(1..N) is within one
    float32 ulp of the reference's (each library's own log)."""
    jcfg = dataclasses.replace(jget("jamba-v0.1-52b"), d_model=64)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), d_model=64)
    jtree = unzip(jssm.init_mamba(jax.random.key(0), jcfg))[0]
    tree = ParamTree(ssm.init_mamba(cfg), torch.bfloat16, "cpu").init_params(
        torch.Generator().manual_seed(0))
    for k, v in jtree.items():
        t = tree[k]
        assert tuple(t.shape) == v.shape, k
        assert str(t.dtype).split(".")[1] == str(v.dtype), k
    np.testing.assert_array_max_ulp(tree["A_log"].numpy(),
                                    np.asarray(jtree["A_log"]), maxulp=1)
    assert torch.all(tree["D"] == 1) and torch.all(tree["conv_b"] == 0)
    cache = ssm.init_mamba_cache(cfg, 3, torch.float32)
    jcache = jssm.init_mamba_cache(jcfg, 3, jnp.float32)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert str(cache[k].dtype).split(".")[1] == str(jcache[k].dtype)
