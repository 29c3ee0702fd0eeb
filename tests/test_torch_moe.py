"""The port's mixture-of-experts layer against the JAX package's.

Same numpy inputs and parameters through ``repro.models.moe`` (its dense
route: ``moe_apply`` with no mesh, and ``_moe_apply_dense``) and
``repro_torch.models.moe``, float32 compute, for three routings:

- granite-moe: top-8 over its full 40 experts (d_model narrowed);
- llama4: top-1 over its full 128 experts with the shared expert;
- a padded expert count (``pad_experts_to``): dead experts never win.

The reference's own routing decisions are recorded from inside it (its
``jax.lax.top_k`` and slot ``jnp.take_along_axis`` calls): the port's
``expert_ids`` and keep mask must equal them exactly.  Outputs,
``moe_aux`` and ``moe_drop`` agree at atol = rtol = 2e-5 (the single-layer
bar of ``tests/test_torch_models.py``); gradients of a scalar of the
output and the aux loss, in the input and every parameter, at rtol 1e-4
with atol 1e-4 times the largest gradient entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import moe

TOL = 2e-5
GRAD_TOL = 1e-4


def moe_cfgs(case):
    """(reference config, port config) at smoke size, float32."""
    arch, over = {
        "granite40top8": ("granite-moe-3b-a800m", {}),
        "llama4_128top1_shared": ("llama4-maverick-400b-a17b", {}),
        "padded": ("granite-moe-3b-a800m",
                   {"num_experts": 6, "top_k": 2, "pad_experts_to": 8}),
    }[case]
    out = []
    for get, reduce in ((jget, jreduce), (get_config, reduce_for_smoke)):
        full = get(arch)
        m = dataclasses.replace(full.moe, d_ff=64, **over)
        out.append(dataclasses.replace(reduce(full), moe=m))
    return out


def moe_params(cfg, seed):
    m, d = cfg.moe, cfg.d_model
    E, f = m.padded_experts(), m.d_ff
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(0, 1, shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    p = {"router": w(d, E), "w_up": w(E, d, f), "w_down": w(E, f, d)}
    if cfg.gated_mlp:
        p["w_gate"] = w(E, d, f)
    if m.shared_expert:
        p.update(shared_up=w(d, f), shared_down=w(f, d))
        if cfg.gated_mlp:
            p["shared_gate"] = w(d, f)
    return p


class RecordRouting:
    """Record the reference's top-k and slot positions from inside its
    ``_moe_apply_dense`` (eager calls, so the values are concrete)."""

    def __init__(self, monkeypatch):
        self.top_k, self.slots = [], []
        top_k, take = jax.lax.top_k, jnp.take_along_axis

        def rec_top_k(x, k):
            out = top_k(x, k)
            self.top_k.append(np.asarray(out[1]))
            return out

        def rec_take(a, idx, axis=None, **kw):
            out = take(a, idx, axis=axis, **kw)
            self.slots.append(np.asarray(out))
            return out

        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jnp, "take_along_axis", rec_take)


def run_both(case, B, S, monkeypatch, entry="dense", seed=0):
    jcfg, cfg = moe_cfgs(case)
    p = moe_params(cfg, seed)
    x = np.random.default_rng(seed + 1).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)
    rec = RecordRouting(monkeypatch)
    jfn = jmoe._moe_apply_dense if entry == "dense" else jmoe.moe_apply
    jout, jaux = jfn({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    fn = moe._moe_apply_dense if entry == "dense" else moe.moe_apply
    out, aux = fn(tp, tx, cfg)
    return jcfg, cfg, p, x, (jout, jaux, rec), (out, aux)


def close(port, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


CASES = ["granite40top8", "llama4_128top1_shared", "padded"]


@pytest.mark.parametrize("entry", ["dense", "moe_apply"])
@pytest.mark.parametrize("B,S", [(2, 32), (4, 1)])
@pytest.mark.parametrize("case", CASES)
def test_moe_matches_reference(case, B, S, entry, monkeypatch):
    """(2, 32): a prefill of 64 tokens; (4, 1): a decode step of batch 4,
    whose capacity is a slot or two per expert."""
    jcfg, cfg, p, x, (jout, jaux, rec), (out, aux) = run_both(
        case, B, S, monkeypatch, entry)
    close(out, jout)
    close(aux["moe_aux"], jaux["moe_aux"])
    close(aux["moe_drop"], jaux["moe_drop"])
    # routing decisions, exactly
    T = B * S
    xf = torch.from_numpy(x).reshape(T, cfg.d_model)
    _, _, ids, slot, keep = moe.route(torch.from_numpy(p["router"]), xf, cfg)
    assert len(rec.top_k) == 1 and len(rec.slots) == 1
    np.testing.assert_array_equal(ids.numpy(), rec.top_k[0])
    want_slot = rec.slots[0][:, 0]
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    cap = moe.capacity_of(cfg.moe, T)
    assert cap == max(1, int(jcfg.moe.capacity_factor * T * jcfg.moe.top_k
                             / jcfg.moe.num_experts))
    np.testing.assert_array_equal(keep.numpy(), want_slot < cap)
    if cfg.moe.pad_experts_to:
        assert ids.max().item() < cfg.moe.num_experts


def test_tokens_beyond_capacity_are_dropped(monkeypatch):
    """More tokens routed to an expert than it has slots: the same pairs
    drop on both sides, and the dropped share is the reference's."""
    _, cfg, p, x, (jout, jaux, rec), (out, aux) = run_both(
        "granite40top8", 2, 32, monkeypatch)
    keep = rec.slots[0][:, 0] < moe.capacity_of(cfg.moe, 64)
    assert not keep.all()
    assert float(aux["moe_drop"]) == pytest.approx(1 - keep.mean(),
                                                   abs=1e-7)
    assert float(jaux["moe_drop"]) > 0


@pytest.mark.parametrize("case", CASES)
def test_moe_grads_match_reference(case):
    """d/d(x, params) of sum(out * g) + moe_aux."""
    jcfg, cfg = moe_cfgs(case)
    p = moe_params(cfg, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)

    def jf(x, p):
        out, aux = jmoe._moe_apply_dense(p, x, jcfg)
        return jnp.sum(out * g) + aux["moe_aux"]

    jx = jnp.asarray(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_val = jf(jx, jp)
    want = jax.grad(jf, argnums=(0, 1))(jx, jp)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out, aux = moe._moe_apply_dense(tp, tx, cfg)
    val = torch.sum(out * torch.from_numpy(g)) + aux["moe_aux"]
    close(val.detach(), want_val, 1e-4)
    names = list(tp)
    got = torch.autograd.grad(val, [tx] + [tp[k] for k in names])
    wants = [want[0]] + [want[1][k] for k in names]
    scale = max(float(np.abs(np.asarray(w)).max()) for w in wants)
    for name, a, b in zip(["x"] + names, got, wants):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=GRAD_TOL * scale, rtol=GRAD_TOL,
                                   err_msg=name)


def test_ties_take_the_lower_expert_first():
    """Equal router probabilities: the lower expert index wins, as
    ``jax.lax.top_k`` orders ties."""
    _, cfg = moe_cfgs("granite40top8")
    E = cfg.moe.padded_experts()
    router = torch.zeros((cfg.d_model, E))
    xf = torch.ones((3, cfg.d_model))
    _, gates, ids, _, _ = moe.route(router, xf, cfg)
    want = np.asarray(jax.lax.top_k(jnp.full((3, E), 1.0 / E),
                                    cfg.moe.top_k)[1])
    np.testing.assert_array_equal(ids.numpy(), want)
    assert ids[0].tolist() == list(range(cfg.moe.top_k))
    torch.testing.assert_close(gates, torch.full_like(gates,
                                                      1 / cfg.moe.top_k))
