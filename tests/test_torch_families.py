"""Whole MoE and hybrid (mamba) models of the port against the JAX
package's: granite-moe-3b-a800m (top-8 MoE), llama4-maverick-400b-a17b
(top-1 MoE with a shared expert, MoE and dense layers interleaved) and
jamba-v0.1-52b (mamba, attention, MLP and MoE layers in one period).

At smoke size, float32, with the reference's own parameters
(``Model.init_params(jax.random.key(k))`` through
:func:`from_jax_params`):

- the state_dict keys are the reference's tree paths, with its leaf
  shapes and dtypes (the mamba ``A_log`` and ``D`` float32);
- prefill logits, one decode step and every cache leaf, at the whole-model
  bar of ``tests/test_torch_models.py`` (atol = rtol = 2e-4);
- ``Model.loss`` (its router aux term is nonzero on these families) and
  every gradient leaf against ``jax.value_and_grad``, at the bars of
  ``tests/test_torch_train.py`` (loss rtol 1e-5, gradients rtol 2e-4 with
  atol 2e-4 times the largest gradient entry);
- the greedy tokens of an ``lm_generate`` gym run at batch 3, which both
  packages bucket-pad to 4 with zero tokens: the padded row competes for
  expert slots in both (ROADMAP C7), so the tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core.spe import _merge_prefill_cache as jmerge
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch.core import Engine
from repro_torch.core.spe import LMGenerateQuery, _merge_prefill_cache
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.params import from_jax_params

from test_torch_models import cfgs, close, jax_model
from test_torch_serve import WALL_KEYS, generations, run, serve_args
from test_torch_train import (
    assert_grads_close, port_grads, reference_loss, to_np,
)

FAMILIES = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
            "jamba-v0.1-52b"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_dict_follows_jax_tree_paths(arch):
    jcfg, cfg = cfgs(arch)
    tree = jax.eval_shape(JModel(jcfg).init_params, jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in from_jax_params(cfg, tree).items()}
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), v.dtype)
           for k, v in model.state_dict().items()}
    assert got == want
    if cfg.moe is not None:
        assert any(k.endswith("ffn.router") for k in got)
    if arch == "jamba-v0.1-52b":
        assert got["groups.0.l0.mixer.A_log"][1] == torch.float32
        assert got["groups.0.l0.mixer.D"][1] == torch.float32
        assert "groups.1.l1.ffn.w_gate" in got


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_and_caches_match_jax(arch):
    jm, tree, port = jax_model(arch, 1)
    cfg = port.cfg
    B, S = 2, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jl, jc = jax.jit(jm.prefill)(tree, jnp.asarray(toks))
    tl, tc = port.prefill(torch.from_numpy(toks).long())
    close(tl, jl, 2e-4)
    jfull = jmerge(jm.init_cache(B, S + 8, jnp.float32), jc, S)
    tfull = _merge_prefill_cache(port.init_cache(B, S + 8, torch.float32),
                                 tc, S)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    jd, jfull = jax.jit(jm.decode_step)(tree, jfull, jnp.asarray(nxt),
                                        jnp.int32(S))
    td, tfull = port.decode_step(tfull, torch.from_numpy(nxt).long(), S)
    close(td, jd, 2e-4)
    n = 0
    for g in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            for name, leaf in tfull[g][f"l{i}"]["mixer"].items():
                want = jfull[f"l{i}"]["mixer"][name][g]
                assert tuple(leaf.shape) == want.shape, (g, i, name)
                close(leaf, want, 2e-4)
                n += 1
    assert n == cfg.n_groups * len(cfg.pattern) * 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    port, batch, loss, metrics, want = reference_loss(arch)
    got_loss, got_m, got = port_grads(port, batch)
    assert float(metrics["aux"]) > 0
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got_m["ce"].item(), metrics["ce"], rtol=1e-5)
    np.testing.assert_allclose(got_m["aux"].item(), metrics["aux"],
                               rtol=1e-5)
    assert_grads_close(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_gym_serve_batch3_matches_reference(monkeypatch, arch):
    """batch 3 is bucket-padded to 4 on both sides (jit_bucket)."""
    def jax_params(self, model):
        # what the reference query draws
        tree = JModel(cfgs(arch)[0]).init_params(jax.random.key(0))
        model.load_state_dict(from_jax_params(model.cfg, to_np(tree)))

    monkeypatch.setattr(LMGenerateQuery, "_init_params", jax_params)
    args = serve_args(arch=arch, batch=3)
    jeng, jsink = run(JEngine, jserve.build_spec, args)
    teng, tsink = run(Engine, serve.build_spec, args)
    want = generations(jsink)
    assert np.asarray(want).shape == (args.requests, 3, args.gen)
    assert generations(tsink) == want
    jm = {k: v for k, v in jeng.metrics().items() if k not in WALL_KEYS}
    tm = {k: v for k, v in teng.metrics().items() if k not in WALL_KEYS}
    assert tm == jm

