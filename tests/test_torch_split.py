"""Split-K decode arithmetic of the port (``csrc/flash_decode.cu``) on the
CPU: ``ref.decode_split`` computes per-split partials over the key ranges
the wrapper's rule gives and merges them by log-sum-exp, as the split and
combine kernels do.  It is held against ``ref.decode`` and against the JAX
package (``repro.kernels.ops.flash_decode``, the Pallas kernel in interpret
mode, and ``repro.kernels.ref.decode``) on the same numpy inputs, at the
float32 tolerance of ``tests/test_kernels.py`` (atol = rtol = 2e-5): the
splits only change the order of float32 sums.

The split rule (``flash_decode.split_count``) is tested as a pure
function.  The kernels themselves are tested on the card by
``tests/test_torch_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ref

# the kernel module: the package name resolves to ops's callable
fd = importlib.import_module("repro_torch.kernels.flash_decode")

# the DECODE_CASES of tests/test_torch_kernels.py, then longer caches and
# windows that start inside a split unit
SPLIT_CASES = [
    # B, S, NH, KV, hd, pos, window, softcap
    (2, 128, 4, 4, 32, 64, 0, 0.0),
    (2, 256, 8, 2, 64, 255, 0, 0.0),
    (1, 512, 8, 1, 64, 0, 0, 0.0),      # pos=0: single valid key
    (1, 256, 4, 2, 32, 200, 64, 0.0),   # window
    (1, 128, 4, 4, 32, 100, 0, 50.0),   # softcap
    (1, 1024, 4, 2, 32, 900, 300, 0.0),
    (2, 1024, 4, 1, 16, 1023, 0, 30.0),
    (1, 2048, 6, 2, 64, 1900, 1000, 0.0),
]
TOL = 2e-5
# the kernel's tiles are 32, 64 or 128 keys (csrc/flash_decode.cu Geo::BK)
KERNEL_TILES = (32, 64, 128)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def close(port, want):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_decode_split_matches_decode_and_jax(case, n_split):
    B, S, NH, KV, hd, pos, window, cap = case
    qa, ka, va = arrays(sum(case[:5]) + n_split, (B, NH, hd),
                        (B, S, KV, hd), (B, S, KV, hd))
    qt, kt, vt = (torch.from_numpy(a) for a in (qa, ka, va))
    kw = dict(scale=hd ** -0.5, window=window, softcap=cap)
    out, (acc, m, l) = ref.decode_split(qt, kt, vt, pos, n_split=n_split,
                                        partials=True, **kw)
    assert out.dtype == torch.float32 and out.shape == (B, NH, hd)
    assert acc.shape == (n_split, B, NH, hd) and m.shape == l.shape \
        == (n_split, B, NH)
    assert torch.isfinite(out).all()
    close(out, ref.decode(qt, kt, vt, pos, **kw).numpy())
    qj, kj, vj = (jnp.asarray(a) for a in (qa, ka, va))
    close(out, jref.decode(qj, kj, vj, pos, **kw))
    close(out, jops.flash_decode(qj, kj, vj, pos, **kw))
    # a split without keys keeps the initial state and weighs nothing
    for i, (start, end) in enumerate(
            ref.split_ranges(*ref.valid_range(pos, window), n_split)):
        if end <= start:
            assert (m[i] == ref.NEG_INF).all() and (l[i] == 0).all()
            assert (acc[i] == 0).all()
        else:
            assert (l[i] >= 1).all()  # the row max contributes exp(0)


def test_decode_split_bf16_q_keeps_its_dtype():
    B, S, NH, KV, hd, pos = 2, 512, 8, 2, 64, 400
    qa, ka, va = arrays(5, (B, NH, hd), (B, S, KV, hd), (B, S, KV, hd))
    q = torch.from_numpy(qa).to(torch.bfloat16)
    k, v = torch.from_numpy(ka), torch.from_numpy(va)
    out = ref.decode_split(q, k, v, pos, n_split=3, scale=hd ** -0.5)
    assert out.dtype == torch.bfloat16
    want = jref.decode(jnp.asarray(qa, jnp.bfloat16), jnp.asarray(ka),
                       jnp.asarray(va), pos, scale=hd ** -0.5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 71), (137, 201), (0, 8192),
                                   (3977, 5001), (901, 1901), (127, 129),
                                   (0, 32768)])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 64])
def test_split_ranges_partition_the_valid_keys(lo, hi, n_split):
    ranges = ref.split_ranges(lo, hi, n_split)
    assert len(ranges) == n_split
    assert ranges[0][0] == lo and ranges[-1][1] == hi
    covered = [k for s, e in ranges for k in range(s, max(s, e))]
    assert covered == list(range(lo, hi))  # contiguous, no key twice
    units = ref.split_units(lo, hi)
    for s, e in ranges:
        if e > s:  # boundaries inside the range sit on unit (tile) edges
            assert s == lo or s % ref.SPLIT_KEYS == 0
            assert e == hi or e % ref.SPLIT_KEYS == 0
    n_empty = sum(e <= s for s, e in ranges)
    assert n_empty == max(0, n_split - units)


def test_split_unit_holds_whole_kernel_tiles():
    assert all(ref.SPLIT_KEYS % t == 0 for t in KERNEL_TILES)


@pytest.mark.parametrize("pos", range(64, 71))
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 4, 8])
def test_split_rule_main_path_takes_one_split(pos, blocks_per_sm):
    """qwen2-7b decode on the main path: B=4 x KV=4 blocks, keys 0..pos
    of the 80-key cache: one split, so no combine kernel launches."""
    assert fd.split_count(4 * 4, *ref.valid_range(pos), 132 * blocks_per_sm) \
        == 1


@pytest.mark.parametrize("B,KV,pos,window,slots", [
    (8, 4, 32767, 0, 264),      # long decode, 32k cache
    (8, 4, 32767, 0, 396),
    (2, 2, 8191, 0, 264),
    (2, 2, 5000, 1024, 264),    # window starting inside a unit
    (1, 1, 1000, 0, 132),
    (1, 4, 4607, 4096, 264),    # gemma2 local layer
    (64, 8, 2047, 0, 264),      # a full card without a split
    (4, 4, 300, 0, 264),
])
def test_split_rule(B, KV, pos, window, slots):
    lo, hi = ref.valid_range(pos, window)
    n = fd.split_count(B * KV, lo, hi, slots)
    units = ref.split_units(lo, hi)
    assert 1 <= n <= fd.MAX_SPLIT
    if n > 1:
        assert n * B * KV <= slots                 # at most one wave
        assert units // n >= fd.MIN_SPLIT_UNITS    # work for every split
    ranges = ref.split_ranges(lo, hi, n)
    assert all(e > s for s, e in ranges)           # never an empty split
    # more splits would break one of the rule's limits
    n1 = n + 1
    assert (n1 * B * KV > slots or units // n1 < fd.MIN_SPLIT_UNITS
            or n1 > fd.MAX_SPLIT)


def test_split_rule_splits_the_long_decode():
    lo, hi = ref.valid_range(32767)
    assert fd.split_count(8 * 4, lo, hi, 132 * 2) == 8
    assert fd.split_count(8 * 4, lo, hi, 132 * 3) == 12


# the decode bundle's sequence split over "model": m ranks each hold S / m
# keys of every KV head; (window, softcap)
SEQ_SPLIT = [(0, 0.0), (0, 30.0), (9, 0.0), (24, 50.0)]


@pytest.mark.parametrize("window,cap", SEQ_SPLIT)
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_chunk_partials_combine_to_decode(m, window, cap):
    """The partials entry on each of m sequence chunks (pos and the window
    global, the chunk's offset given), combined over the ranks by the
    combine entry, equal ``ref.decode`` and the reference's
    ``ref.decode`` at every position; a chunk with no valid key gives
    m = NEG_INF and l = 0."""
    B, S, NH, KV, hd = 2, 64, 8, 2, 16
    qa, ka, va = arrays(m + window, (B, NH, hd), (B, S, KV, hd),
                        (B, S, KV, hd))
    q, k, v = (torch.from_numpy(a) for a in (qa, ka, va))
    c = S // m
    kw = dict(scale=hd ** -0.5, window=window, softcap=cap)
    for pos in range(S):
        parts = [fd.partials(q, k[:, r * c:(r + 1) * c],
                             v[:, r * c:(r + 1) * c], pos, offset=r * c,
                             **kw) for r in range(m)]
        acc, mx, l = (torch.cat([p[i] for p in parts]) for i in range(3))
        assert acc.shape == (m, B, NH, hd) and l.shape == (m, B, NH)
        out = fd.combine(acc, mx, l, torch.float32)
        close(out, ref.decode(q, k, v, pos, **kw))
        close(out, jref.decode(jnp.asarray(qa), jnp.asarray(ka),
                               jnp.asarray(va), pos, **kw))
        lo, hi = ref.valid_range(pos, window)
        for r in range(m):
            if ref.chunk_range(pos, window, r * c, c) == (0, 0):
                assert r * c >= hi or (r + 1) * c <= lo
                assert torch.all(mx[r] == ref.NEG_INF)
                assert torch.all(l[r] == 0) and torch.all(acc[r] == 0)
