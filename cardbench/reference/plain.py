"""A decoder's math in plain PyTorch, float32, for the correctness check.

Written from the published descriptions (RMSNorm, rotary embeddings by
split halves, grouped-query attention, SwiGLU, top-k routed experts with a
capacity, AdamW), not from the program: no kernel, cache layout, fused
path or batching trick of the port is used.  Every matrix product goes
through a ``Precision``: :class:`Float32` (the reference: float32 with
TF32 off, see :func:`float32_products`) or :class:`FP8` (the control: each
product's operands rounded to float8 e4m3 with one scale a tensor, the
gradients' to e5m2, accumulated in float32, as an fp8 GEMM does).

The weights are a mapping from the leaf names of
``benchlib.weights.leaf_specs`` to tensors, read in float32.  Activations
are processed in blocks of rows so that a full-size model fits the card
after the program's state is freed.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ROWS = 4096          # tokens per block of a feed-forward layer or the head
Q_CHUNK = 512        # queries per block of attention


@contextlib.contextmanager
def float32_products():
    """Matrix products in full float32: TF32 off while the reference
    runs, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class Float32:
    name = "float32"

    @staticmethod
    def mm(a, b):
        """a (..., K) @ b (K, N) or batched (G, M, K) @ (G, K, N)."""
        return torch.matmul(a, b)


def _fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` rounded to ``dtype`` under one scale for the tensor, back in
    float32."""
    t = t.float()
    if t.numel() == 0:
        return t
    amax = t.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).float() / scale


class _FP8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            gb = (qa.reshape(-1, qa.shape[-1]).T
                  @ qg.reshape(-1, qg.shape[-1]))
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


class FP8:
    name = "fp8"

    @staticmethod
    def mm(a, b):
        return _FP8Product.apply(a, b)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta: float):
    """Rotary embedding by split halves: x (B, S, H, hd), pos (S,)
    integers.  The angles are computed in float64."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * freqs[None, :]     # (S, half)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, q0: int, k0: int, lp):
    """Causal grouped-query attention in blocks of queries: q (B, Sq, H,
    hd) at positions q0 .. q0 + Sq - 1; k, v (B, Sk, KV, hd) at positions
    k0 ..; query head h reads KV head h // (H / KV), and a query sees the
    keys at its position and before."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    kt = k.permute(0, 2, 3, 1).reshape(B * KV, hd, -1)        # (BK, hd, Sk)
    vt = v.permute(0, 2, 1, 3).reshape(B * KV, -1, hd)        # (BK, Sk, hd)
    qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)   # (B,KV,G,Sq,hd)
    outs = []
    for s in range(0, Sq, Q_CHUNK):
        c = min(Q_CHUNK, Sq - s)
        n = q0 + s + c - k0                   # keys up to the block's last
        qc = qg[:, :, :, s:s + c].reshape(B * KV, G * c, hd) * hd ** -0.5
        scores = lp.mm(qc, kt[:, :, :n]).view(B * KV, G, c, n)
        qp = q0 + s + torch.arange(c, device=q.device)
        kp = k0 + torch.arange(n, device=q.device)
        seen = kp[None, :] <= qp[:, None]                     # (c, n)
        probs = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
        o = lp.mm(probs.view(B * KV, G * c, n), vt[:, :n])    # (BK, G*c, hd)
        outs.append(o.view(B, KV, G, c, hd))
    out = torch.cat(outs, dim=3)                               # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * hd)


def swiglu(x, w_gate, w_up, w_down, lp):
    return lp.mm(F.silu(lp.mm(x, w_gate)) * lp.mm(x, w_up), w_down)


def in_rows(fn, x):
    """``fn`` over blocks of ``ROWS`` tokens of x (..., D)."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.cat([fn(flat[i:i + ROWS]) for i in range(0, flat.shape[0],
                                                           ROWS)])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def moe(x, router, w_gate, w_up, w_down, top_k: int, capacity_factor: float,
        lp):
    """Top-k routed experts over the tokens x (T, D), GShard-style: the
    router's softmax, the k largest probabilities (ties to the lower
    expert) renormalised; each expert takes at most C = int(factor * T *
    k / E) of its (token, choice) pairs, earlier tokens first, and a
    dropped pair adds nothing.  Returns (out (T, D), Switch aux loss =
    E * sum(mean prob * share of first choices))."""
    T, D = x.shape
    E = router.shape[1]
    probs = torch.softmax(lp.mm(x, router), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k] / vals[:, :top_k].sum(-1, keepdim=True)
    ids = ids[:, :top_k]
    cap = max(1, int(capacity_factor * T * top_k / E))
    pair_expert = ids.reshape(-1)                     # token-major pairs
    order = torch.argsort(pair_expert, stable=True)
    counts = torch.bincount(pair_expert, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(pair_expert)
    slot[order] = torch.arange(T * top_k, device=x.device) - \
        first[pair_expert[order]]
    kept = slot < cap
    pair_gate = gates.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(E):
        pairs = torch.nonzero((pair_expert == e) & kept)[:, 0]
        tok = pairs // top_k
        y = swiglu(x[tok], w_gate[e], w_up[e], w_down[e], lp)
        out = out.index_add(0, tok, y * pair_gate[pairs, None])
    first_choice = F.one_hot(ids[:, 0], E).float().mean(0)
    return out, E * torch.sum(probs.mean(0) * first_choice)


def cross_entropy_sum(x, w_out, labels, lp):
    """Sum over tokens of -log softmax(x @ w_out)[label], in blocks."""
    flat, lab = x.reshape(-1, x.shape[-1]), labels.reshape(-1)

    def block(xb, lb):
        logits = lp.mm(xb, w_out)
        return torch.sum(torch.logsumexp(logits, -1) -
                         logits.gather(-1, lb[:, None])[:, 0])

    return sum(checkpoint(block, flat[i:i + ROWS], lab[i:i + ROWS],
                          use_reentrant=False)
               for i in range(0, flat.shape[0], ROWS))


# ---------------------------------------------------------------------------
# Entries: a configuration's ``layer`` over the whole model
# ---------------------------------------------------------------------------


def train_loss(layer, w, c, inputs, labels, lp):
    """(ce + 0.01 * the layers' summed aux, ce): ``layer(w, g, x, pos, c,
    lp) -> (x, k, v, aux)`` run under activation checkpointing, one layer
    at a time."""
    x = w["embed.embedding"].float()[inputs.long()]
    pos = torch.arange(inputs.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)

    def one(x, g):
        out, _, _, a = layer(w, g, x, pos, c, lp)
        return out, a

    for g in range(c["num_hidden_layers"]):
        x, a = checkpoint(one, x, g, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, w["final_norm.scale"].float(), c["rms_norm_eps"])
    ce = cross_entropy_sum(x, _head(w, c), labels, lp) / labels.numel()
    return ce + 0.01 * aux, ce


def _head(w, c):
    return (w["embed.embedding"].float().T if c["tie_word_embeddings"]
            else w["embed.unembed"].float())


@torch.no_grad()
def prefill(layer, w, c, tokens, positions, lp):
    """One prompt tokens (S,): (the last position's logits (V,), K and V
    after each layer at ``positions``, (L, P, KV, hd) each)."""
    x = w["embed.embedding"].float()[tokens.long()][None]
    pos = torch.arange(tokens.shape[0], device=x.device)
    ks, vs = [], []
    for g in range(c["num_hidden_layers"]):
        x, k, v, _ = layer(w, g, x, pos, c, lp)
        ks.append(k[0, positions])
        vs.append(v[0, positions])
    x = rmsnorm(x[:, -1], w["final_norm.scale"].float(), c["rms_norm_eps"])
    return lp.mm(x, _head(w, c))[0], torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def extend(layer, w, c, tokens, start: int, history, lp):
    """Rows of tokens (R, T) at positions start .. start + T - 1, after a
    history of ``start`` positions: ``history(g) -> (K, V)`` (R, start,
    KV, hd) float32 for layer g.  Returns (logits (R, T, V), K and V of
    the new positions after each layer, (L, R, T, KV, hd) each)."""
    x = w["embed.embedding"].float()[tokens.long()]
    pos = torch.arange(start, start + tokens.shape[1], device=x.device)
    ks, vs = [], []
    for g in range(c["num_hidden_layers"]):
        x, k, v, _ = layer(w, g, x, pos, c, lp, past=history(g))
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, w["final_norm.scale"].float(), c["rms_norm_eps"])
    return in_rows(lambda t: lp.mm(t, _head(w, c)), x), torch.stack(ks), \
        torch.stack(vs)


def attention_block(w, p, h, pos, c, lp, past=None):
    """The attention sublayer on normed h (B, S, D): (out (B, S, D), this
    call's post-rope K and V (B, S, KV, hd)).  ``past`` (K, V) of the
    positions before ``pos[0]`` are attended to as well."""
    B, S, _ = h.shape
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])

    def proj(n, heads):
        y = lp.mm(h, w[p + "w" + n].float())
        if c["attention_bias"]:
            y = y + w[p + "b" + n].float()
        return y.view(B, S, heads, hd)

    q = rope(proj("q", H), pos, c["rope_theta"])
    k = rope(proj("k", KV), pos, c["rope_theta"])
    v = proj("v", KV)
    ka, va = k, v
    if past is not None:
        ka, va = torch.cat([past[0], k], 1), torch.cat([past[1], v], 1)
    q0 = int(pos[0])
    out = attention(q, ka, va, q0, q0 - (ka.shape[1] - S), lp)
    return lp.mm(out, w[p + "wo"].float()), k, v


# ---------------------------------------------------------------------------
# AdamW with the parameters kept in the configuration's dtype
# ---------------------------------------------------------------------------


def lr_at(o: dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_ratio * lr`` at ``total_steps``."""
    w, total = o["warmup_steps"], o["total_steps"]
    if step < w:
        return o["lr"] * step / max(1.0, w)
    prog = min(max((step - w) / max(1.0, total - w), 0.0), 1.0)
    return o["lr"] * (o["min_ratio"] + (1 - o["min_ratio"]) * 0.5 *
                      (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int,
               o: dict, store_dtype):
    """One AdamW step (decoupled decay ``lr * wd * p``, the gradients first
    clipped to a global norm of ``clip_norm``), every leaf in float32 and
    then rounded to the parameters' dtype ``store_dtype``, as the
    configuration keeps them.  Returns the clip scale."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(o["clip_norm"] / torch.clamp(norm, min=1e-9),
                        max=1.0)
    lr = lr_at(o, step)
    bc1, bc2 = 1 - o["b1"] ** step, 1 - o["b2"] ** step
    for k, p in params.items():
        g = grads[k] * scale
        m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
        v[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
        upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + o["eps"])
        new = p - lr * (upd + o["weight_decay"] * p)
        p.copy_(new.to(store_dtype).float())
    return scale
