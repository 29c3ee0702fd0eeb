"""The port's optimizer, schedule and train steps against the JAX package.

Parameters, gradients and batches are made by numpy from a seed (train
states by the reference's own init, converted with ``from_jax_state``)
and go through ``repro.optim`` / ``repro.train`` and their ports on the
CPU.  Tolerances:

- float32 parameters and moments: rtol 2e-6, atol 1e-9 (a few float32
  roundings of the same arithmetic in the same order; XLA and torch may
  round a power or a square root differently in the last place);
- bfloat16 parameters or moments: one bfloat16 step of the value
  (rtol 2**-7): a last-place float32 difference before the cast can round
  to the neighbouring bfloat16 value;
- the schedule: rtol 1e-6 (float32 cosine);
- train steps: losses rtol 1e-5 (whole-model float32, as in
  ``tests/test_torch_train.py``); the moments, which hold the gradients,
  rtol 2e-4 with atol 2e-4 of the model's largest entry (the gradient
  bar of ``tests/test_torch_train.py``); each step's parameter delta
  (new - old, within each package) within one float32 step of the
  parameter on each side plus 1e-3 of the step's learning rate.  At the
  reference's step-1 learning rate (1.5e-7) a delta is a few float32
  steps of the parameter, so raw parameters would hide an error.  The
  delta is held where the gradient is resolved: where |m| is at least 20
  times the moments' atol.  Adam divides each entry by its own gradient
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


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_reference(param_dtype, state_dtype,
                                        grad_scale):
    """Five steps with new gradients each step, through a warmup schedule
    (lr not constant); the global norm of the gradients is ~0.2 (no clip)
    or ~60 (clipped to 1)."""
    kw = dict(state_dtype=state_dtype)
    jopt = JAdamW(JOptConfig(**kw), jcosine(3e-2, 3, 10))
    opt = AdamW(OptConfig(**kw), cosine_warmup(3e-2, 3, 10))
    jp, tp = both(tree(0), param_dtype)
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for step in range(5):
        jg, tg = both(tree(10 + step, grad_scale), param_dtype)
        jp, jstate = jopt.update(jg, jstate, jp)
        tp, tstate = opt.update(tg, tstate, tp)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        for k in SHAPES:
            assert tp[k].dtype == TDT[param_dtype]
            assert tstate["m"][k].dtype == TDT[state_dtype]
        assert_tree_close(tp, jp, param_dtype)
        assert_tree_close(tstate["m"], jstate["m"], state_dtype)
        assert_tree_close(tstate["v"], jstate["v"], state_dtype)


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
        for part in ("m", "v"):
            got_p, want_p = state["opt"][part], want["opt"][part]
            scale = max(float(w.abs().max()) for w in want_p.values())
            for key, g in got_p.items():
                np.testing.assert_allclose(
                    g.numpy(), want_p[key].numpy(), rtol=2e-4,
                    atol=2e-4 * scale, err_msg=f"{part} {key}")
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


def test_unported_bundles_raise():
    cfg = reduce_for_smoke(get_config("qwen2-7b"))
    for kind in ("prefill", "decode"):
        with pytest.raises(NotImplementedError, match="A12"):
            make_step_bundle(cfg, ShapeCfg("s", 16, 2, kind))
    with pytest.raises(NotImplementedError, match="A11"):
        make_step_bundle(cfg, ShapeCfg("s", 16, 2, "train"), mesh=object())
    for fn in (train_input_specs, serve_input_specs):
        with pytest.raises(NotImplementedError, match="A12"):
            fn(cfg, ShapeCfg("s", 16, 2, "train"))
