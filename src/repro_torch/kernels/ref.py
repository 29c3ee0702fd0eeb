"""Plain torch oracles for the attention kernels.

These deliberately materialize the full (Sq, Sk) score matrix — they are
the *semantic* references the CUDA kernels are tested against, and the
path a kernel wrapper takes for a tensor that lies on the CPU.  They run
on any device, so ``chip_smoke.py`` also holds the kernels against them
on the card.  Counterparts of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _mask(sq: int, sk: int, *, causal: bool, window: int, device,
          q_offset: int = 0):
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= (qpos - kpos) < window
    return m


def attention(q, k, v, *, scale: float, causal: bool = True,
              window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, NH, hd); k, v: (B, Sk, KV, hd).  GQA via head groups.

    Returns (B, Sq, NH, hd) in q.dtype; softmax in f32.
    """
    B, Sq, NH, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = NH // KV
    qg = q.reshape(B, Sq, KV, G, hd).float() * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, NH, hd).to(q.dtype)


def decode(q, k_cache, v_cache, pos: int, *, scale: float, window: int = 0,
           softcap: float = 0.0):
    """q: (B, NH, hd); caches: (B, S, KV, hd) (any strides); pos: int.

    Attends to cache positions <= pos (inclusive).  Returns (B, NH, hd)
    in q.dtype.
    """
    B, NH, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = NH // KV
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    valid = kpos <= pos
    if window:
        valid &= (pos - kpos) < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, NH, hd).to(q.dtype)


# Split-K decode (csrc/flash_decode.cu): the valid keys are cut into units
# of SPLIT_KEYS keys (a multiple of every tile of the kernel), and split i
# of n takes units [i * nu // n, (i + 1) * nu // n) of the nu units the
# valid range touches, clipped to the range.  The kernel computes the same
# ranges from its block index.
SPLIT_KEYS = 128


def valid_range(pos: int, window: int = 0) -> tuple[int, int]:
    """The keys [lo, hi) a decode step at ``pos`` attends."""
    return (max(0, pos - window + 1) if window else 0), pos + 1


def split_units(lo: int, hi: int) -> int:
    """How many SPLIT_KEYS-key units the keys [lo, hi) touch."""
    return -(-hi // SPLIT_KEYS) - lo // SPLIT_KEYS


def split_ranges(lo: int, hi: int, n_split: int) -> list[tuple[int, int]]:
    """The key range [start, end) of each of ``n_split`` splits of [lo, hi).

    A split gets no keys (end <= start) only when n_split exceeds
    :func:`split_units`; the wrapper's rule never picks such a count.
    """
    u0, nu = lo // SPLIT_KEYS, split_units(lo, hi)
    out = []
    for i in range(n_split):
        us, ue = u0 + i * nu // n_split, u0 + (i + 1) * nu // n_split
        out.append((max(lo, us * SPLIT_KEYS), min(hi, ue * SPLIT_KEYS)))
    return out


def chunk_range(pos: int, window: int, offset: int,
                length: int) -> tuple[int, int]:
    """The keys [lo, hi) of a cache chunk that holds global keys
    [offset, offset + length) which a decode step at global ``pos``
    attends, in the chunk's own coordinates; (0, 0) when it holds none."""
    lo, hi = valid_range(pos, window)
    lo, hi = max(lo - offset, 0), min(hi - offset, length)
    return (lo, hi) if lo < hi else (0, 0)


def combine(acc, m, l, dtype):
    """Merge float32 partials (acc (n, B, NH, hd), m and l (n, B, NH)) by
    log-sum-exp: M = max m_i, w_i = exp(m_i - M), o = sum w_i acc_i /
    max(sum w_i l_i, 1e-30).  A partial without keys (m = NEG_INF, l = 0)
    weighs 0 next to any with keys.  Returns o (B, NH, hd) in ``dtype``."""
    w = torch.exp(m - m.amax(dim=0))
    den = torch.clamp((w * l).sum(dim=0), min=1e-30)
    return ((w[..., None] * acc).sum(dim=0) / den[..., None]).to(dtype)


def decode_split(q, k_cache, v_cache, pos: int, *, n_split: int,
                 scale: float, window: int = 0, softcap: float = 0.0,
                 partials: bool = False, offset: int = 0):
    """:func:`decode` computed as the split-K kernel computes it.

    Each split of :func:`split_ranges` gives float32 partials over its
    keys: acc (unnormalized P.V), m (row max) and l (row sum of
    exp(s - m)); a split without keys keeps m = NEG_INF, l = 0, acc = 0.
    They are merged by :func:`combine`.  Returns o in q.dtype, and with
    ``partials`` also (acc (n, B, NH, hd), m (n, B, NH), l (n, B, NH)).

    With ``offset`` the caches are a chunk of a longer cache that holds
    its global keys [offset, offset + S): ``pos`` and the window stay
    global, and the chunk's keys are split as :func:`chunk_range` gives
    them (a chunk with no valid key gives n partials without keys).
    """
    B, NH, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = NH // KV
    qg = q.reshape(B, KV, G, hd).float() * scale
    accs, ms, ls = [], [], []
    for start, end in split_ranges(*chunk_range(pos, window, offset, S),
                                   n_split):
        if end <= start:
            accs.append(torch.zeros((B, KV, G, hd), device=q.device))
            ms.append(torch.full((B, KV, G), NEG_INF, device=q.device))
            ls.append(torch.zeros((B, KV, G), device=q.device))
            continue
        s = torch.einsum("bkgh,bskh->bkgs", qg,
                         k_cache[:, start:end].float())
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        accs.append(torch.einsum("bkgs,bskh->bkgh", p,
                                 v_cache[:, start:end].float()))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    acc = torch.stack(accs).reshape(n_split, B, NH, hd)
    m = torch.stack(ms).reshape(n_split, B, NH)
    l = torch.stack(ls).reshape(n_split, B, NH)
    o = combine(acc, m, l, q.dtype)
    return (o, (acc, m, l)) if partials else o


def rmsnorm(x, scale, *, eps: float = 1e-6, zero_centered: bool = False):
    """x: (..., D); scale: (D,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    sf = scale.float()
    if zero_centered:
        sf = 1.0 + sf
    return (xf * torch.rsqrt(var + eps) * sf).to(x.dtype)
