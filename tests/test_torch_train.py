"""Training in the port against the JAX package, on the CPU.

The same numpy inputs and the reference's own parameters (its init,
converted with ``np.asarray`` and loaded by ``from_jax_params``) go
through ``repro`` and ``repro_torch``:

- ``ops.flash_attention``'s gradients: the reference's custom VJP (the
  Pallas forward in interpret mode, the backward through its jnp oracle)
  against the port's autograd function (on the CPU the forward is the
  plain version, the backward a recompute through ``ref.attention``);
- ``Model.loss`` and the gradient of every leaf against
  ``jax.value_and_grad(model.loss)``, for smoke qwen2-7b, gemma2-2b and
  xlstm-125m, over the port's remat policies, the ``flash_xla`` attention
  and a loss of several sequence chunks;
- the data pipeline copy, bit for bit;
- the gym ``lm_train`` run against the reference's gym run.

Tolerances: attention grads atol = rtol = 5e-5 (the bar of the
reference's ``test_flash_attention_grads_match_ref``); whole-model float32
losses rtol 1e-5; gradients rtol 2e-4 with atol 2e-4 times the largest
gradient entry of the model (the whole-model bar of
``tests/test_torch_models.py``).  The atol is taken over the model, not
the leaf: an entry is a float32 sum over B x S positions, each package
sums in its own order, and the error follows the size of the terms, not
of their sum.  The mLSTM gate biases show it: their gradients cancel to
~1e-6 through the stabilizer and differ by ~1e-3 of themselves.  The
port's remat policies give identical gradients: the same operations
recompute the same values on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_for_smoke as jreduce
from repro.core import Engine as JEngine
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro.train import make_step_bundle as jbundle
from repro.configs.base import ShapeCfg as JShape
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import Engine
from repro_torch.core.spe import LMTrainQuery
from repro_torch.core.spec import Component
from repro_torch.data import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.models.params import from_jax_params, from_jax_state
from repro_torch.train import load_state

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: torch's intra-op threads only contend with
    the other test workers' (a step's small ops ran ~90x slower with a
    full thread pool in each of six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_CASES = [
    # B, S, NH, KV, hd, window, softcap (tests/test_kernels.py)
    (2, 64, 4, 4, 32, 0, 0.0),
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 256, 8, 1, 64, 0, 0.0),
    (1, 128, 4, 2, 32, 32, 0.0),
    (1, 128, 4, 2, 32, 0, 50.0),
    (1, 96, 2, 2, 16, 24, 30.0),
]
ARCHS = ["qwen2-7b", "gemma2-2b", "xlstm-125m"]
WALL_KEYS = ("wall_s", "profile_wall")


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (a) the autograd function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attention_grads_match_reference(case):
    B, S, NH, KV, hd, window, cap = case
    q, k, v, g = arrays(1, (B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd),
                        (B, S, NH, hd))
    s = hd ** -0.5

    def jf(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, s, True, window, cap)
                       * jnp.asarray(g))

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, s, True, window, cap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=5e-5)
    # the backward is autograd through the plain version, exactly
    plain = ref.attention(tq, tk, tv, scale=s, window=window, softcap=cap)
    exact = torch.autograd.grad(plain, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, exact):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_attention_grads_only_where_asked():
    q, k, v = (torch.from_numpy(a) for a in
               arrays(2, (1, 32, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    q.requires_grad_()
    out = ops.flash_attention(q, k, v, 0.25, True, 0, 0.0)
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    assert k.grad is None and v.grad is None


# ---------------------------------------------------------------------------
# (b) Model.loss and every gradient leaf
# ---------------------------------------------------------------------------


def batch_arrays(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def reference_loss(arch, seed=0, seq_chunk=512, **over):
    """(port model with the reference's params, batch, loss, metrics,
    grads as a state_dict-keyed dict)."""
    jcfg = dataclasses.replace(jreduce(jget(arch)), **over)
    jm = JModel(jcfg)
    tree = jm.init_params(jax.random.key(seed))
    batch = batch_arrays(jcfg.vocab_size, seed=seed)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          seq_chunk=seq_chunk), has_aux=True)(tree)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **over)
    port = Model(cfg, device="cpu")
    port.load_state_dict(from_jax_params(cfg, to_np(tree)))
    port.requires_grad_(True)
    return (port, {k: torch.from_numpy(v) for k, v in batch.items()},
            float(loss), to_np(metrics),
            from_jax_params(cfg, to_np(grads)))


def port_grads(model, batch, seq_chunk=512):
    params = dict(model.named_parameters())
    loss, metrics = model.loss(batch, seq_chunk=seq_chunk)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, metrics, dict(zip(params, grads))


def assert_grads_close(got, want, tol=2e-4):
    assert got.keys() == want.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for key, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[key].float().numpy(),
                                   atol=tol * scale, rtol=tol, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Every remat policy of the port against the reference's (smoke
    configs: remat none); the port's policies agree exactly."""
    port, batch, loss, metrics, want = reference_loss(arch)
    by_remat = {}
    for remat in ("none", "full", "dots"):
        port.cfg = dataclasses.replace(port.cfg, remat=remat)
        got_loss, got_m, by_remat[remat] = port_grads(port, batch)
        np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
        np.testing.assert_allclose(got_m["ce"].item(), metrics["ce"],
                                   rtol=1e-5)
        assert float(got_m["aux"]) == float(metrics["aux"]) == 0.0
    assert_grads_close(by_remat["none"], want)
    for remat in ("full", "dots"):
        for key, g in by_remat[remat].items():
            torch.testing.assert_close(g, by_remat["none"][key], atol=0,
                                       rtol=0, msg=f"{remat}: {key}")


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b"])
def test_loss_and_grads_flash_xla_attention(arch):
    port, batch, loss, _, want = reference_loss(arch, seed=1,
                                                attn_impl="flash_xla")
    got_loss, _, got = port_grads(port, batch)
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
    assert_grads_close(got, want)


@pytest.mark.parametrize("arch", ["gemma2-2b", "xlstm-125m"])
def test_loss_over_several_chunks(arch):
    """seq_chunk 16 of S=64: four checkpointed chunks; the same loss as
    one chunk, up to the order of the chunk sums."""
    port, batch, loss, _, want = reference_loss(arch, seed=2, seq_chunk=16)
    got_loss, _, got = port_grads(port, batch, seq_chunk=16)
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
    assert_grads_close(got, want)
    one, _ = port.loss(batch)
    np.testing.assert_allclose(one.item(), got_loss.item(), rtol=1e-6)


def test_serving_keeps_no_graph():
    """prefill and decode run without autograd even with gradients on."""
    cfg = reduce_for_smoke(get_config("qwen2-7b"))
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    logits, cache = model.prefill(torch.zeros((1, 8), dtype=torch.long))
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in cache
                   for layer in c.values() for t in layer["mixer"].values())


# ---------------------------------------------------------------------------
# (e) the data pipeline copy
# ---------------------------------------------------------------------------


def test_data_copy_gives_the_reference_batches():
    cfg = reduce_for_smoke(get_config("qwen2-7b"))
    for step, rank in ((0, 0), (5, 2), (17, 3)):
        a = pipeline.SyntheticLM(1000, 64, seed=3).batch(step, rank, 4)
        b = jpipe.SyntheticLM(1000, 64, seed=3).batch(step, rank, 4)
        for key in ("inputs", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype
    a = pipeline.ModalityStub(64, 16, vocab_size=512).batch(1, 0, 2)
    b = jpipe.ModalityStub(64, 16, vocab_size=512).batch(1, 0, 2)
    for key in ("inputs", "labels"):
        np.testing.assert_array_equal(a[key], b[key])
    its = [pipeline.make_train_batches(cfg, 32, 8, rank=r, world=4,
                                       start_step=17) for r in range(4)]
    jits = [jpipe.make_train_batches(cfg, 32, 8, rank=r, world=4,
                                     start_step=17) for r in range(4)]
    for it, jit in zip(its, jits):
        for _ in range(2):
            np.testing.assert_array_equal(next(it)["inputs"],
                                          next(jit)["inputs"])
    out = [b["x"][0] for b in pipeline.Prefetcher(
        iter([{"x": np.full((2,), i)} for i in range(10)]), depth=3)]
    assert out == list(range(10))


# ---------------------------------------------------------------------------
# (i) training in the gym
# ---------------------------------------------------------------------------


def gym_args(**kw):
    a = dict(arch="xlstm-125m", steps=4, batch=2, seq=24, seed=0,
             device="cpu", full=False)
    a.update(kw)
    return type("Args", (), a)


def gym_run(engine_cls, args, build):
    spec, cons = build(args)
    eng = engine_cls(spec, seed=args.seed)
    eng.run(until=args.steps * 0.2 + 30.0)
    sink = [rt for rt in eng.runtimes if rt.name == cons.name][0]
    return eng, [(p["data"] if "data" in p else p) for p in sink.payloads]


def reference_gym_spec(args):
    """The spec of ``repro.launch.train.run_gym`` (which builds and runs
    it in one function), with the same components."""
    from repro.core import PipelineSpec
    spec = PipelineSpec()
    spec.add_switch("s1")
    for h in ["data", "broker", "trainer", "sink"]:
        spec.add_host(h)
        spec.add_link(h, "s1", lat=0.5, bw=10_000.0)
    spec.add_broker("broker")
    spec.add_topic("batches", leader="broker")
    spec.add_topic("metrics", leader="broker")
    spec.add_producer("data", "TOKENS", topic="batches", batch=args.batch,
                      seqLen=args.seq, totalMessages=args.steps,
                      interval=0.2, seed=args.seed)
    spec.add_spe("trainer", query="lm_train", inTopic="batches",
                 outTopic="metrics", arch=args.arch, seed=args.seed)
    cons = spec.add_consumer("sink", "METRICS", topic="metrics",
                             pollInterval=0.1)
    return spec, cons


@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-125m"])
def test_gym_train_matches_reference(monkeypatch, arch):
    """The port's query starts from the reference's initial state; each
    metric message's loss agrees at rtol 1e-5 and its step exactly, and
    every non-wall engine metric is equal."""
    def jax_state(self, bundle):
        jb = jbundle(jreduce(jget(arch)), JShape("gym", 1, 1, "train"))
        state = bundle.init_fn(torch.Generator().manual_seed(0))
        load_state(state, from_jax_state(
            self.cfg, to_np(jb.init_fn(jax.random.key(self._seed)))))
        return state

    monkeypatch.setattr(LMTrainQuery, "_init_params", jax_state)
    args = gym_args(arch=arch)
    jeng, want = gym_run(JEngine, args, reference_gym_spec)
    teng, got = gym_run(Engine, args, train.build_gym_spec)
    assert len(want) == args.steps
    assert [p["step"] for p in got] == [p["step"] for p in want] == \
        [1, 2, 3, 4]
    np.testing.assert_allclose([p["loss"] for p in got],
                               [p["loss"] for p in want], rtol=1e-5)
    jm = {k: v for k, v in jeng.metrics().items() if k not in WALL_KEYS}
    tm = {k: v for k, v in teng.metrics().items() if k not in WALL_KEYS}
    assert tm == jm


def test_lm_train_defaults_to_cuda():
    """The query's device is cuda unless the spec says cpu; without a GPU
    it raises, with no fallback."""
    query = LMTrainQuery(Component("spe", "JAXSTREAM", {}, name="spe_t"))
    if torch.cuda.is_available():
        query._build()
        assert query.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            query._build()
