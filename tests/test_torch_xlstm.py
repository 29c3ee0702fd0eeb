"""The port's xLSTM blocks and the xlstm-125m model against the JAX package.

Inputs are made by numpy from a seed, parameters by the reference's own
init (converted with ``np.asarray``), and both go through the JAX
function and its port on the CPU.  Tolerances, as in
``tests/test_torch_models.py``: float32 atol = rtol = 2e-5 for single
functions, 2e-4 for whole-model logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.core.spe import _merge_prefill_cache as jmerge
from repro.models import Model as JModel
from repro.models import ssm as jssm, xlstm as jx
from repro.models.params import unzip
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.spe import _merge_prefill_cache
from repro_torch.models import Model
from repro_torch.models import ssm, xlstm
from repro_torch.models.params import from_jax_params

ARCH = "xlstm-125m"


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def close(port, want, tol=2e-5):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def T(a):
    return torch.from_numpy(np.asarray(a))


def cfgs():
    return jreduce(jget(ARCH)), reduce_for_smoke(get_config(ARCH))


def gates(seed, B, S, H):
    """log input gates and log forget gates (log-sigmoid of N(3, 1))."""
    li, f = arrays(seed, (B, S, H), (B, S, H))
    lf = -np.log1p(np.exp(-(f + 3.0))).astype(np.float32)
    return li, lf


def block_params(init, cfg, seed):
    """The reference's init of one block, with the constant leaves
    (biases, skip, scales) redrawn so that every leaf matters."""
    tree = {k: np.array(v) for k, v in
            unzip(init(jax.random.key(seed), cfg))[0].items()}
    rng = np.random.default_rng(seed)
    for k in ("b_i", "b_f", "conv_b", "skip", "norm_scale", "b"):
        if k in tree:
            tree[k] = (tree[k] + 0.3 * rng.normal(0, 1, tree[k].shape)
                       ).astype(tree[k].dtype)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: T(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# _causal_conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", [1, 7])
def test_causal_conv(with_cache, S):
    x, w, b, c = arrays(0, (2, S, 16), (4, 16), (16,), (2, 3, 16))
    cache = c if with_cache else None
    jo, jc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if cache is None else jnp.asarray(c))
    to, tc = ssm._causal_conv(T(x), T(w), T(b),
                              None if cache is None else T(c))
    close(to, jo)
    if with_cache:
        close(tc, jc)
    else:
        assert tc is None and jc is None


def test_causal_conv_casts_the_cache_to_the_input_dtype():
    x, w, b, c = arrays(1, (1, 1, 8), (4, 8), (8,), (1, 3, 8))
    _, tc = ssm._causal_conv(T(x).bfloat16(), T(w).bfloat16(),
                             T(b).bfloat16(), T(c))
    assert tc.dtype == torch.bfloat16 and tc.shape == (1, 3, 8)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(16, 128), (64, 64), (256, 64)])
def test_mlstm_scan(S, chunk):
    """S < chunk, one chunk, four chunks."""
    B, H, dh = 2, 3, 8
    q, k, v = arrays(2, (B, S, H, dh), (B, S, H, dh), (B, S, H, dh))
    li, lf = gates(3, B, S, H)
    jh, js = jx.mlstm_scan(*map(jnp.asarray, (q, k, v, li, lf)),
                           chunk=chunk)
    th, ts = xlstm.mlstm_scan(*map(T, (q, k, v, li, lf)), chunk=chunk)
    close(th, jh)
    for a, b in zip(ts, js):
        close(a, b)


def test_mlstm_scan_from_a_carried_state():
    B, S, H, dh = 2, 32, 2, 8
    q, k, v = arrays(4, (B, S, H, dh), (B, S, H, dh), (B, S, H, dh))
    li, lf = gates(5, B, S, H)
    C, n = arrays(6, (B, H, dh, dh), (B, H, dh))
    m = np.random.default_rng(7).normal(0, 2, (B, H)).astype(np.float32)
    jh, js = jx.mlstm_scan(*map(jnp.asarray, (q, k, v, li, lf)),
                           state=tuple(map(jnp.asarray, (C, n, m))),
                           chunk=16)
    th, ts = xlstm.mlstm_scan(*map(T, (q, k, v, li, lf)),
                              state=tuple(map(T, (C, n, m))), chunk=16)
    close(th, jh)
    for a, b in zip(ts, js):
        close(a, b)


def test_mlstm_scan_keeps_the_chunk_contract():
    q = torch.zeros(1, 96, 1, 4)
    g = torch.zeros(1, 96, 1)
    with pytest.raises(AssertionError):
        xlstm.mlstm_scan(q, q, q, g, g, chunk=64)


def test_mlstm_decode_step():
    B, H, dh = 3, 2, 8
    q, k, v, C, n = arrays(8, (B, H, dh), (B, H, dh), (B, H, dh),
                           (B, H, dh, dh), (B, H, dh))
    li, lf = (a[:, 0] for a in gates(9, B, 1, H))
    m = np.random.default_rng(10).normal(0, 2, (B, H)).astype(np.float32)
    jh, js = jx.mlstm_decode_step(*map(jnp.asarray, (q, k, v, li, lf)),
                                  tuple(map(jnp.asarray, (C, n, m))))
    th, ts = xlstm.mlstm_decode_step(*map(T, (q, k, v, li, lf)),
                                     tuple(map(T, (C, n, m))))
    close(th, jh)
    for a, b in zip(ts, js):
        close(a, b)


@pytest.mark.parametrize("S,chunk", [(24, 128), (64, 16)])
def test_chunkwise_scan_equals_a_loop_of_decode_steps(S, chunk):
    """In the port itself: the chunkwise form and the recurrent form are
    the same recurrence."""
    B, H, dh = 2, 2, 8
    q, k, v = arrays(11, (B, S, H, dh), (B, S, H, dh), (B, S, H, dh))
    li, lf = gates(12, B, S, H)
    h, (C, n, m) = xlstm.mlstm_scan(*map(T, (q, k, v, li, lf)),
                                    chunk=chunk)
    cache = xlstm.init_mlstm_cache(
        dataclasses.replace(cfgs()[1], d_model=H * dh // 2, n_heads=H),
        B)
    state = (cache["C"], cache["n"], cache["m"])
    hs = []
    for t in range(S):
        ht, state = xlstm.mlstm_decode_step(
            *(T(a[:, t]) for a in (q, k, v, li, lf)), state)
        hs.append(ht)
    close(torch.stack(hs, 1), h.numpy(), 1e-4)
    for a, b in zip(state, (C, n, m)):
        close(a, b.numpy(), 1e-4)


def test_headwise_rmsnorm():
    h, s = arrays(13, (2, 5, 4, 8), (32,))
    close(xlstm._headwise_rmsnorm(T(h), T(s)),
          jx._headwise_rmsnorm(jnp.asarray(h), jnp.asarray(s)))


def _apply_both(japply, tapply, jp, tp, jcfg, cfg, x, **kw):
    jcache, tcache = kw.pop("jcache", None), kw.pop("tcache", None)
    jo, jc = japply(jp, jnp.asarray(x), jcfg, cache=jcache, **kw)
    to, tc = tapply(tp, T(x), cfg, cache=tcache, **kw)
    close(to, jo)
    if jc is None:
        assert tc is None
    else:
        assert tc.keys() == jc.keys()
        for name in jc:
            close(tc[name], jc[name])
    return jc, tc


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_block_prefill_then_decode(mixer):
    jcfg, cfg = cfgs()
    japply, tapply = ((jx.mlstm_apply, xlstm.mlstm_apply) if mixer == "mlstm"
                      else (jx.slstm_apply, xlstm.slstm_apply))
    init = jx.init_mlstm if mixer == "mlstm" else jx.init_slstm
    jp, tp = block_params(init, jcfg, 14)
    x, x1 = arrays(15, (2, 12, cfg.d_model), (2, 1, cfg.d_model))
    # without state, then prefill with return_state
    _apply_both(japply, tapply, jp, tp, jcfg, cfg, x)
    jc, tc = _apply_both(japply, tapply, jp, tp, jcfg, cfg, x,
                         return_state=True)
    # two decode steps from the prefill state
    for step in range(2):
        jc, tc = _apply_both(japply, tapply, jp, tp, jcfg, cfg,
                             x1 + step, jcache=jc, tcache=tc)


def test_slstm_cell():
    B, H, dh = 2, 4, 8
    c, n, h, wx, r = arrays(16, (B, H, dh), (B, H, dh), (B, H, dh),
                            (B, 4, H, dh), (4, H, dh, dh))
    m = np.random.default_rng(17).normal(0, 1, (B, H, dh)).astype(
        np.float32)
    n = np.abs(n)
    jc = jx._slstm_cell(tuple(map(jnp.asarray, (c, n, h, m))),
                        jnp.asarray(wx), jnp.asarray(r * 0.05))
    tc = xlstm._slstm_cell(tuple(map(T, (c, n, h, m))), T(wx),
                           T(r * 0.05))
    for a, b in zip(tc, jc):
        close(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_shapes_and_dtypes(dtype):
    jcfg, cfg = cfgs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for jinit, tinit in ((jx.init_mlstm_cache, xlstm.init_mlstm_cache),
                         (jx.init_slstm_cache, xlstm.init_slstm_cache)):
        want = jinit(jcfg, 3, jdt)
        got = tinit(cfg, 3, dtype)
        assert got.keys() == want.keys()
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype).split(".")[1] == \
                str(want[name].dtype), name
            close(got[name], want[name], 0)
    # the sLSTM states are separate tensors (a prefill merge writes each)
    s = xlstm.init_slstm_cache(cfg, 1)
    assert len({t.data_ptr() for t in s.values()}) == 4


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def expected_state_dict(jcfg):
    """(key -> (shape, dtype name)) of the reference's init, with the
    stacked group axis unrolled as the port's state_dict does."""
    shapes = jax.eval_shape(JModel(jcfg).init_params, jax.random.key(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", p)))
                 for p in path]
        shape, dt = tuple(leaf.shape), str(leaf.dtype)
        if names[0] == "groups" and jcfg.scan_layers:
            for g in range(shape[0]):
                out[".".join(["groups", str(g)] + names[1:])] = (shape[1:],
                                                                 dt)
        else:
            out[".".join(names)] = (shape, dt)
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoke", [True, False])
def test_state_dict_matches_reference_init(param_dtype, smoke):
    """Keys, shapes and dtypes; a bf16 tree keeps the reference's float32
    leaves (mLSTM b_i, b_f; sLSTM r, b).  Full width on the meta device."""
    jcfg, cfg = (cfgs() if smoke else (jget(ARCH), get_config(ARCH)))
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    want = expected_state_dict(jcfg)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in Model(cfg, device="meta").state_dict().items()}
    assert got == want
    f32 = {k for k, (_, dt) in got.items() if dt == "float32"}
    if param_dtype == "bfloat16":
        assert {k.rsplit(".", 1)[1] for k in f32} == {"b_i", "b_f", "r", "b"}


def test_init_params_draws_the_reference_constants():
    _, cfg = cfgs()
    m = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    mix = m.groups[0].l0.mixer
    assert (mix.b_f == 3.0).all() and (mix.b_i == 0).all()
    sl = m.groups[0].l3.mixer
    d = cfg.d_model
    want = torch.cat([torch.zeros(d), torch.full((d,), 3.0),
                      torch.zeros(2 * d)])
    assert torch.equal(sl.b, want)
    dh = d // cfg.n_heads
    assert 0.04 < sl.r.std().item() < 0.06 and sl.r.shape == (
        4, cfg.n_heads, dh, dh)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def jax_model(seed):
    jcfg, cfg = cfgs()
    jm = JModel(jcfg)
    tree = jm.init_params(jax.random.key(seed))
    port = Model(cfg, device="cpu")
    port.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray,
                                                           tree)))
    return jm, tree, port


@pytest.mark.parametrize("S", [16, 40])
def test_model_prefill_and_decode_match_reference(S):
    jm, tree, port = jax_model(0)
    cfg = port.cfg
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    jl, jc = jm.prefill(tree, jnp.asarray(toks))
    tl, tc = port.prefill(T(toks))
    close(tl, jl, 2e-4)
    jfull = jmerge(jm.init_cache(2, S + 8, jnp.float32), jc, S)
    tfull = _merge_prefill_cache(port.init_cache(2, S + 8, torch.float32),
                                 tc, S)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    for i in range(3):
        jd, jfull = jm.decode_step(tree, jfull, jnp.asarray(nxt),
                                   jnp.int32(S + i))
        td, tfull = port.decode_step(tfull, T(nxt), S + i)
        close(td, jd, 2e-4)
        nxt = np.argmax(np.asarray(jd)[:, -1], -1)[:, None]
    for g in range(cfg.n_groups):
        for layer, names in (("l0", ("C", "n", "m", "conv")),
                             ("l3", ("c", "n", "h", "m"))):
            for name in names:
                close(tfull[g][layer]["mixer"][name],
                      jfull[layer]["mixer"][name][g], 2e-4)


def test_prefill_state_is_merged_into_the_decode_cache():
    """States pass through the splice unchanged; the conv state (compute
    dtype) is cast into the cache's dtype."""
    _, _, port = jax_model(1)
    toks = T(np.random.default_rng(2).integers(0, 512, (1, 8)))
    _, pc = port.prefill(toks)
    full = _merge_prefill_cache(port.init_cache(1, 20, torch.bfloat16),
                                pc, 8)
    for g in range(port.cfg.n_groups):
        for layer in ("l0", "l3"):
            for name, t in full[g][layer]["mixer"].items():
                src = pc[g][layer]["mixer"][name]
                assert t.shape == src.shape
                assert torch.equal(t, src.to(t.dtype)), (layer, name)
        assert full[g]["l0"]["mixer"]["conv"].dtype == torch.bfloat16


def test_decode_matches_a_fresh_prefill():
    """Decode at position S equals a prefill of S+1 tokens."""
    cfg = reduce_for_smoke(get_config(ARCH))
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    toks = T(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 21)))
    la, _ = model.prefill(toks)
    _, pc = model.prefill(toks[:, :20])
    cache = _merge_prefill_cache(model.init_cache(2, 32, torch.float32),
                                 pc, 20)
    ld, _ = model.decode_step(cache, toks[:, 20:21], 20)
    close(ld[:, -1], la[:, -1].numpy(), 2e-4)


def test_long_prefill_runs_in_chunks():
    """S = 256 is two 128-chunks of mLSTM and 256 sLSTM steps."""
    jm, tree, port = jax_model(3)
    toks = np.random.default_rng(4).integers(0, 512, (1, 256))
    jl, _ = jm.prefill(tree, jnp.asarray(toks))
    tl, _ = port.prefill(T(toks))
    close(tl, jl, 2e-4)
