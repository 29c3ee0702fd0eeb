"""The port's optimizer, schedule and train steps against the JAX package.

Parameters, gradients and batches are made by numpy from a seed (train
states by the reference's own init, converted with ``from_jax_state``)
and go through ``repro.optim`` / ``repro.train`` and their ports on the
CPU.  Tolerances:

- AdamW over five steps: each package is held, step by step, to the
  same step computed in float64 from the state that package carries,
  within a bound on float32's rounding of each operation of the formula
  (``Bound``, ``adamw_oracle``); the port is held to the reference within
  the sum of the two bounds and the float64 distance of the two steps.
  The global norm and clip, and the default lr without clip, are held at
  rtol 2e-6, atol 1e-9 (float32) or one bfloat16 step (rtol 2**-7);
- the schedule: rtol 1e-6 (float32 cosine);
- train steps: losses rtol 1e-5 (whole-model float32, as in
  ``tests/test_torch_train.py``); the moments, which hold the gradients,
  within the gradient bar of ``tests/test_torch_train.py`` (rtol 2e-4,
  atol 2e-4 of the model's largest entry) carried through the moment
  updates entry by entry (``moment_tolerances``); each step's parameter
  delta (new - old, within each package) within one float32 step of the
  parameter on each side plus 1e-3 of the step's learning rate.  At the
  reference's step-1 learning rate (1.5e-7) a delta is a few float32
  steps of the parameter, so raw parameters would hide an error.  The
  delta is held where the gradient is resolved: where |m| is at least 20
  times 2e-4 of the largest |m|.  Adam divides each entry by its own gradient
  scale, so an entry whose gradient is within the tolerance of zero can
  step either way (its sign is float32 noise in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.configs.base import ShapeCfg as JShape
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import (
    AdamW as JAdamW, OptConfig as JOptConfig,
    clip_by_global_norm as jclip, cosine_warmup as jcosine,
    global_norm as jglobal_norm,
)
from repro.train import make_step_bundle as jbundle
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.models.params import from_jax_state
from repro_torch.optim import (
    AdamW, OptConfig, clip_by_global_norm, cosine_warmup, global_norm,
)
from repro_torch.train import load_state, make_step_bundle
from repro_torch.train.steps import serve_input_specs, train_input_specs

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: torch's intra-op threads only contend with
    the other test workers' (a step's small ops ran ~90x slower with a
    full thread pool in each of six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"w": (16, 8), "b": (8,), "e": (4, 3, 5)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, scale, s)).astype(np.float32)
            for k, s in SHAPES.items()}


def both(d, dtype):
    return ({k: jnp.asarray(v, JDT[dtype]) for k, v in d.items()},
            {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in d.items()})


def assert_tree_close(got, want, dtype, keys=SHAPES):
    tol = dict(rtol=2e-6, atol=1e-9) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=0)
    for k in keys:
        np.testing.assert_allclose(
            got[k].float().numpy(), np.asarray(want[k], np.float32),
            err_msg=k, **tol)


# ---------------------------------------------------------------------------
# (c) AdamW, the norm and the schedule
# ---------------------------------------------------------------------------


U32, U16 = 2.0 ** -24, 2.0 ** -8      # unit roundoff, float32 / bfloat16
UNIT = {"float32": U32, "bfloat16": U16}
POW_ULPS = 2          # b1 ** step in float32: within 2 ulps (libm pow)


class Bound:
    """A float64 value ``v`` and a bound ``e`` on how far a float32
    computation of it can be.  Each operation adds one unit roundoff ``u``
    (half a float32 ulp) of its result to the bounds its operands carry
    (first and second order), as IEEE float32 ``+ * / sqrt`` round."""

    def __init__(self, v, e=0.0):
        self.v = np.asarray(v, np.float64)
        self.e = np.asarray(e, np.float64) + 0 * self.v

    @staticmethod
    def of(x):
        return x if isinstance(x, Bound) else Bound(x)

    @staticmethod
    def const(c):
        """A Python float that the formula rounds to float32."""
        return Bound(c, U32 * abs(c))

    def rounded(self, u=U32):
        return Bound(self.v, self.e + u * (np.abs(self.v) + self.e))

    def __add__(self, o):
        o = Bound.of(o)
        return Bound(self.v + o.v, self.e + o.e).rounded()

    def __sub__(self, o):
        o = Bound.of(o)
        return Bound(self.v - o.v, self.e + o.e).rounded()

    def __mul__(self, o):
        o = Bound.of(o)
        return Bound(self.v * o.v, np.abs(self.v) * o.e
                     + np.abs(o.v) * self.e + self.e * o.e).rounded()

    def __truediv__(self, o):
        o = Bound.of(o)
        assert np.all(np.abs(o.v) > o.e)
        return Bound(self.v / o.v, (self.e + np.abs(self.v / o.v) * o.e)
                     / (np.abs(o.v) - o.e)).rounded()

    def sqrt(self):
        r = np.sqrt(self.v)
        return Bound(r, self.e / (r + np.sqrt(np.maximum(self.v - self.e,
                                                          0)))).rounded()


def adamw_oracle(params, m, v, grads, step, lr, c, param_dtype,
                 state_dtype):
    """One step of ``repro/optim/adamw.py`` in float64 from a carried
    state (dicts of float64 arrays), with a bound on each entry's float32
    rounding.

    k, the count behind the bounds, for ``m`` with float32 throughout:
    the squares of the n = 196 gradient entries round once, and their sum
    takes at most 129 additions per term in any order (127 within the
    128-entry leaf, 2 across the three leaves), so the sum of squares is
    within 130u of its value; the norm, its square root, within 65u + u;
    the clip scale ``1/norm`` within 67u.  ``(1-b1) * fl(g*scale)``
    carries 67u + 3u (the product with the scale, the constant, the
    product), ``b1 * m_prev`` 2u, the sum 1u more: 74u of
    max(|m_prev|, |(1-b1) g scale|), that is k = 37 float32 ulps (eps |x|)
    with the clip active and k = 2 without it (scale exactly 1).  ``v``
    doubles the scale's share (the square of the clipped gradient).  A
    bfloat16 cast adds 2**-8 of its value; ``b ** step`` is taken within
    ``POW_ULPS`` ulps."""
    n_terms = sum(g.size for g in grads.values())
    depth = (max(g.size for g in grads.values()) - 1) + (len(grads) - 1)
    sq = sum(float(np.sum(np.square(g))) for g in grads.values())
    sumsq = Bound(sq, (depth + 1) * U32 * sq)
    assert n_terms == 196 and depth == 129
    norm = sumsq.sqrt()
    if norm.v - norm.e > c.clip_norm:        # clip active in float32 too
        scale = Bound(c.clip_norm) / norm
    else:
        assert norm.v + norm.e < c.clip_norm, "clip undecided"
        scale = Bound(1.0)
    stepf = float(step)

    def bias_correction(b):
        bt = b ** stepf
        return Bound(1.0) - Bound(bt, bt * U32 * (stepf + 2 * POW_ULPS))

    bc1, bc2 = bias_correction(c.b1), bias_correction(c.b2)
    out = {"p": {}, "m": {}, "v": {}}
    for k, g in grads.items():
        g32 = (Bound(g) * scale).rounded(
            UNIT[param_dtype] if param_dtype != "float32" else 0.0)
        m32 = Bound.const(c.b1) * Bound(m[k]) + Bound.const(1 - c.b1) * g32
        v32 = (Bound.const(c.b2) * Bound(v[k])
               + Bound.const(1 - c.b2) * g32 * g32)
        delta = (m32 / bc1) / ((v32 / bc2).sqrt() + Bound.const(c.eps))
        p32 = Bound(params[k])
        p32 = p32 - Bound(lr) * (delta + Bound.const(c.weight_decay) * p32)
        for part, x, dt in (("p", p32, param_dtype), ("m", m32, state_dtype),
                            ("v", v32, state_dtype)):
            out[part][k] = x.rounded(UNIT[dt]) if dt != "float32" else x
    return out


def f64(tree):
    return {k: np.asarray(t.float() if isinstance(t, torch.Tensor)
                          else jnp.asarray(t, jnp.float32), np.float64)
            for k, t in tree.items()}


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_reference(param_dtype, state_dtype,
                                        grad_scale):
    """Five steps with new gradients each step, through a warmup schedule
    (lr not constant); the global norm of the gradients is ~0.2 (no clip)
    or ~60 (clipped to 1).

    Each step, each package's new parameters and moments are held to
    ``adamw_oracle`` of the state it carried into the step, at the bound
    the oracle gives (its docstring counts k); the port is held to the
    reference at the sum of the two bounds plus the float64 distance of
    the two oracle steps (zero while the carried states are equal, as at
    step 1).  The last two float32 cases failed their former flat bar
    (atol 1e-9, rtol 2e-6) on some machines by 2 ulps where ``m`` nearly
    cancels: 1.86e-9 in 2 of 128 entries of ``m["w"]``, with operands of
    ~1e-2."""
    kw = dict(state_dtype=state_dtype)
    jopt = JAdamW(JOptConfig(**kw), jcosine(3e-2, 3, 10))
    opt = AdamW(OptConfig(**kw), cosine_warmup(3e-2, 3, 10))
    jp, tp = both(tree(0), param_dtype)
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for part in ("m", "v"):
        for k in SHAPES:
            assert not tstate[part][k].any() and not jstate[part][k].any()
    for step in range(5):
        jg, tg = both(tree(10 + step, grad_scale), param_dtype)
        carried = {"ref": (f64(jp), f64(jstate["m"]), f64(jstate["v"])),
                   "port": (f64(tp), f64(tstate["m"]), f64(tstate["v"]))}
        lrs = {"ref": float(jopt.lr_fn(step + 1)),
               "port": float(opt.lr_fn(step + 1))}
        jp, jstate = jopt.update(jg, jstate, jp)
        tp, tstate = opt.update(tg, tstate, tp)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        for k in SHAPES:
            assert tp[k].dtype == TDT[param_dtype]
            assert tstate["m"][k].dtype == TDT[state_dtype]
        got = {"ref": {"p": f64(jp), "m": f64(jstate["m"]),
                       "v": f64(jstate["v"])},
               "port": {"p": f64(tp), "m": f64(tstate["m"]),
                        "v": f64(tstate["v"])}}
        want = {who: adamw_oracle(*carried[who], f64(tg), step + 1,
                                  lrs[who], opt.cfg, param_dtype,
                                  state_dtype)
                for who in ("ref", "port")}
        for part in ("p", "m", "v"):
            for k in SHAPES:
                for who in ("ref", "port"):
                    w = want[who][part][k]
                    err = np.abs(got[who][part][k] - w.v)
                    assert (err <= w.e).all(), \
                        (who, part, k, step, float((err / w.e).max()))
                o_ref, o_port = want["ref"][part][k], want["port"][part][k]
                bar = o_ref.e + o_port.e + np.abs(o_ref.v - o_port.v)
                err = np.abs(got["port"][part][k] - got["ref"][part][k])
                assert (err <= bar).all(), \
                    ("port-ref", part, k, step, float((err / bar).max()))


def test_adamw_default_lr_and_no_clip():
    """Constant lr (no schedule) and clip_norm 0."""
    jopt = JAdamW(JOptConfig(lr=0.1, clip_norm=0.0, weight_decay=0.0))
    opt = AdamW(OptConfig(lr=0.1, clip_norm=0.0, weight_decay=0.0))
    jp, tp = both(tree(1), "float32")
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for step in range(3):
        jg, tg = both(tree(20 + step, 5.0), "float32")
        jp, jstate = jopt.update(jg, jstate, jp)
        tp, tstate = opt.update(tg, tstate, tp)
    assert_tree_close(tp, jp, "float32")


def test_adamw_converges_quadratic():
    opt = AdamW(OptConfig(lr=0.1, weight_decay=0.0))
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3, requires_grad=True)}
    state = opt.init(params)
    for _ in range(300):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [params["w"]])
        params, state = opt.update({"w": g}, state, params)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    jt, tt = both(tree(3, 2.0), dtype)
    np.testing.assert_allclose(float(global_norm(tt)),
                               float(jglobal_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e9):
        (got, norm), (want, jnorm) = (clip_by_global_norm(tt, max_norm),
                                      jclip(jt, max_norm))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        assert_tree_close(got, want, dtype)
        assert all(got[k].dtype == TDT[dtype] for k in SHAPES)


def test_clip_by_global_norm():
    t = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(t, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90 + 160))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm(t, 1e9)
    np.testing.assert_allclose(same["a"].numpy(), 3.0)


@pytest.mark.parametrize("step", [0, 1, 2000, 51000, 100000, 120000])
def test_cosine_warmup_matches_reference(step):
    lr, jlr = cosine_warmup(3e-4, 2000, 100_000), jcosine(3e-4, 2000,
                                                         100_000)
    got = lr(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jlr(step)), rtol=1e-6)
    t = lr(torch.tensor(step, dtype=torch.int32))
    assert float(t) == float(got)


def test_cosine_warmup_shape():
    lr = cosine_warmup(1.0, 100, 1000, min_ratio=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(50)) == pytest.approx(0.5)
    assert float(lr(100)) == pytest.approx(1.0)
    assert float(lr(1000)) == pytest.approx(0.1, abs=1e-6)
    assert float(lr(550)) < float(lr(150))


# ---------------------------------------------------------------------------
# (d) the train step bundle
# ---------------------------------------------------------------------------


def reference_run(arch, k, steps, B=4, S=32):
    """The reference's first ``steps`` train steps from init key 0 on
    SyntheticLM batches; returns (cfg, initial state, states after each
    step, losses) as numpy trees."""
    jcfg = dataclasses.replace(jreduce(jget(arch)), microbatches=k)
    b = jbundle(jcfg, JShape("t", S, B, "train"))
    state = b.init_fn(jax.random.key(0))
    src = JSyntheticLM(jcfg.vocab_size, S, seed=0)
    step_fn = jax.jit(b.step_fn)
    init = jax.tree.map(np.asarray, state)
    states, losses = [], []
    for i in range(steps):
        batch = {kk: jnp.asarray(v) for kk, v in src.batch(i, 0, B).items()}
        state, m = step_fn(state, batch)
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(m["loss"]))
    return init, states, losses


GRAD_BAR = 2e-4      # the gradient bar of tests/test_torch_train.py


def moment_tolerances(tol, m_prev, m_new, b1=OptConfig.b1,
                      b2=OptConfig.b2):
    """Per-entry tolerances of the moments after one train step, from the
    reference's moments before (``m_prev``) and after (``m_new``) it, and
    the tolerances ``tol`` = {"m": ..., "v": ...} carried into the step.

    The step's clipped gradient, entry by entry, is the reference's
    ``g = (m_new - b1 m_prev) / (1 - b1)``; the port's is held to it at
    the gradient bar of ``tests/test_torch_train.py``:
    ``dg = GRAD_BAR (|g| + G)``, G the model's largest |g|.  Carried
    through ``m = b1 m + (1-b1) g`` and ``v = b2 v + (1-b2) g**2`` that
    is ``b1 tol_m + (1-b1) dg`` and ``b2 tol_v + (1-b2) (2|g| dg + dg**2)``:
    for ``v`` the bar scales with each entry's squared-gradient magnitude
    (``|g| (|g| + G)``), where a flat ``GRAD_BAR`` times the largest |v|
    scales with G**2.  That flat bar failed on some machines for 1 of
    65536 entries of ``v embed.embedding`` (xlstm-125m: 5.84e-7 against
    atol 3.46e-7)."""
    g = {k: (m_new[k].double() - b1 * m_prev[k].double()) / (1 - b1)
         for k in m_new}
    G = max(float(x.abs().max()) for x in g.values())
    out = {"m": {}, "v": {}}
    for k, x in g.items():
        dg = GRAD_BAR * (x.abs() + G)
        out["m"][k] = b1 * tol["m"][k] + (1 - b1) * dg
        out["v"][k] = b2 * tol["v"][k] + (1 - b2) * (2 * x.abs() * dg
                                                     + dg * dg)
    return out


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "k2"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "xlstm-125m"])
def test_train_steps_match_reference(arch, k):
    B, S, steps = 4, 32, 3
    init, want_states, want_losses = reference_run(arch, k, steps, B, S)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              microbatches=k)
    bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    load_state(state, from_jax_state(cfg, init))
    src = JSyntheticLM(cfg.vocab_size, S, seed=0)
    jlr = jcosine(3e-4, 2000, 100_000)
    prev = {key: t.detach().clone()
            for key, t in state["params"].state_dict().items()}
    prev_want = from_jax_state(cfg, init)["params"]
    m_want = from_jax_state(cfg, init)["opt"]["m"]
    mtol = {part: {key: torch.zeros(t.shape, dtype=torch.float64)
                  for key, t in m_want.items()} for part in ("m", "v")}
    n_resolved = 0
    for i in range(steps):
        batch = {kk: torch.from_numpy(v) for kk, v in
                 src.batch(i, 0, B).items()}
        state, m = bundle.step_fn(state, batch)
        assert int(m["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), want_losses[i],
                                   rtol=1e-5)
        want = from_jax_state(cfg, want_states[i])
        m_max = max(float(w.abs().max()) for w in want["opt"]["m"].values())
        mtol = moment_tolerances(mtol, m_want, want["opt"]["m"])
        m_want = want["opt"]["m"]
        for part in ("m", "v"):
            got_p, want_p = state["opt"][part], want["opt"][part]
            for key, g in got_p.items():
                err = (g.double() - want_p[key].double()).abs()
                assert (err <= mtol[part][key]).all(), \
                    (part, key, float((err / mtol[part][key]).max()))
        lr = float(jlr(i + 1))
        for key, p in state["params"].state_dict().items():
            w, eps = want["params"][key], torch.finfo(p.dtype).eps
            tol = eps * (torch.maximum(prev[key].abs(), p.abs())
                         + torch.maximum(prev_want[key].abs(), w.abs())) \
                + 1e-3 * lr
            err = ((p - prev[key]) - (w - prev_want[key])).abs()
            resolved = want["opt"]["m"][key].abs() >= 20 * 2e-4 * m_max
            n_resolved += int(resolved.sum())
            assert (err <= tol)[resolved].all(), \
                (key, float((err - tol)[resolved].max()) / lr)
            prev[key] = p.detach().clone()
        prev_want = want["params"]
    assert n_resolved > 0


def test_step_deltas_are_not_zero():
    """The parameter deltas compared above move: one step changes every
    leaf of a smoke model (lr 1.5e-7 at step 1)."""
    cfg = reduce_for_smoke(get_config("qwen2-7b"))
    bundle = make_step_bundle(cfg, ShapeCfg("t", 16, 2, "train"))
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in state["params"].state_dict().items()}
    batch = {kk: torch.from_numpy(v) for kk, v in
             JSyntheticLM(cfg.vocab_size, 16).batch(0, 0, 2).items()}
    state, m = bundle.step_fn(state, batch)
    assert np.isfinite(float(m["loss"]))
    for k, t in state["params"].state_dict().items():
        assert not torch.equal(t, before[k]), k


def test_serve_bundles_and_input_specs_exist():
    """The prefill and decode bundles and the input specs are ported:
    mesh-free, ``prefill`` is ``Model.prefill`` and ``serve_step``
    ``Model.decode_step``, bit for bit; the specs are meta tensors (their
    shapes and dtypes against the reference:
    ``tests/test_torch_serve_specs.py``; the bundles on meshes:
    ``tests/test_torch_serve_bundles.py``); a kind the reference does not
    know raises."""
    from repro_torch.models import Model
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-7b")),
                              cache_dtype="float32")
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"))
    db = make_step_bundle(cfg, ShapeCfg("d", S, B, "decode"))
    assert pb.mesh is None and pb.in_shardings is None
    logits, cache = pb.step_fn(model, toks)
    want, plain = model.prefill(toks)
    assert torch.equal(logits, want)
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    logits, cache = db.step_fn(model, cache, nxt, torch.tensor(S - 1))
    want, plain = model.decode_step(plain, nxt, S - 1)
    assert torch.equal(logits, want)
    for gc, gp in zip(cache, plain):
        for layer in gc:
            for n, t in gc[layer]["mixer"].items():
                assert torch.equal(t, gp[layer]["mixer"][n])
    shape = ShapeCfg("s", S, B, "decode")
    assert train_input_specs(cfg, shape)["inputs"].device.type == "meta"
    assert serve_input_specs(cfg, shape)["tokens"].device.type == "meta"
    with pytest.raises(ValueError, match="score"):
        make_step_bundle(cfg, ShapeCfg("s", S, B, "score"))
