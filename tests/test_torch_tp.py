"""Tensor parallelism over ``model`` in the port's mesh step, on the CPU.

The reference runs in one subprocess on 4 forced CPU devices, on meshes
built by ``jax.sharding.Mesh`` (``Auto`` axes, ROADMAP C8), where XLA
partitions its dense layers from the parameter specs.  The port runs on
4 gloo ranks (``_torch_ranks.run_sides``), where the mesh step computes
the attention, MLP, embedding and unembedding leaves on each rank's
``model`` chunk (``distributed.sharding.tp_plan``).  Each side writes an
npz and the tests compare them here.

Cases, smoke configs (d_model 128, 4 query heads of 32), 2 steps at
batch 8 x 32, the same config changes on both sides:

- qwen2-7b with ``n_kv_heads=2`` (G=2, qkv bias, untied) on (1, 2) and
  (1, 4) ``("data", "model")``; at m=4 the 2 KV heads do not split, so
  each rank computes the KV head its query head reads from the whole
  ``wk``/``wv`` (stored as quarter-head chunks);
- gemma2-2b (tied embeddings, attention and final softcaps,
  ``query_pre_attn_scalar``) with ``fsdp_params`` on (2, 2), its sliding
  window cut to 16 so that it bites at S=32 on the local layers;
- granite-34b (MQA; its stored K/V halves split the one head) on (1, 2);
- granite-moe-3b-a800m with ``ep_shard`` on (2, 2): expert parallelism
  and tensor-parallel attention on one ``model`` axis.

What is checked: both steps' losses (rtol 1e-5); each rank's chunks of
the parameters and moments against the reference's shards at its
coordinate, at ``tests/test_torch_distributed.py``'s tolerances (its
module doc); that the plan splits what the config allows, that each
tensor-parallel leaf's compute view holds 1/m of its elements with
``Shard`` on ``model`` (never gathered whole over ``model``); the
vocab-parallel cross-entropy on 2 ranks against ``torch.logsumexp``; and
that on a (1, 1) mesh, where the same code runs with its collectives as
identities, the step equals the mesh-free step bit for bit.  In this
process: the plan's decisions for the full configs, and the KV heads
that a rank's query heads read where the KV heads do not split,
including groupings that no smoke config reaches.
"""
import json
import math
import os

import numpy as np
import pytest

from _torch_ranks import run_sides
from test_torch_distributed import _flat, _hold_step, _lr

B, S, STEPS = 8, 32, 2
ALL = {"heads", "kv_heads", "ffn", "vocab"}
# name: (arch, mesh shape, config changes, kinds the plan splits)
CASES = {
    "qwen2_12": ("qwen2-7b", (1, 2), dict(n_kv_heads=2), ALL),
    "qwen2_14": ("qwen2-7b", (1, 4), dict(n_kv_heads=2),
                 {"heads", "ffn", "vocab"}),
    "gemma2_22": ("gemma2-2b", (2, 2),
                  dict(fsdp_params=True, sliding_window=16), ALL),
    "granite34_12": ("granite-34b", (1, 2), {}, {"heads", "ffn", "vocab"}),
    "moe_22": ("granite-moe-3b-a800m", (2, 2), dict(ep_shard=True),
               {"heads", "kv_heads", "vocab"}),
}
AXES = ("data", "model")
ONE_RANK = ("qwen2_12", "gemma2_22")      # on a (1, 1) mesh, bit for bit
# the leaves of each kind, by the ends of their keys
KIND_LEAVES = {"heads": (".mixer.wq", ".mixer.bq", ".mixer.wo"),
               "kv_heads": (".mixer.wk", ".mixer.wv", ".mixer.bk",
                            ".mixer.bv"),
               "ffn": (".ffn.w_up", ".ffn.w_gate", ".ffn.w_down"),
               "vocab": ("embed.embedding", "embed.unembed")}
CE_SHAPE, CE_VOCAB = (4, 8), 64
TIMEOUT = 240


def _cfg(arch: str, over: dict, pkg: str):
    import dataclasses
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    cfg = mod.reduce_for_smoke(mod.get_config(arch))
    if "ep_shard" in over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, ep_shard=over["ep_shard"]))
    return dataclasses.replace(
        cfg, **{k: v for k, v in over.items() if k != "ep_shard"})


def _ce_inputs():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, CE_SHAPE + (CE_VOCAB,)).astype(np.float32)
    labels = rng.integers(0, CE_VOCAB, CE_SHAPE)
    return logits, labels


# ---------------------------------------------------------------------------
# The reference, on 4 forced devices
# ---------------------------------------------------------------------------


def ref_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLM
    from repro.train import make_step_bundle

    assert jax.device_count() == 4, jax.devices()
    res = {}

    def shards(prefix, state, m):
        for key, arr in _flat(state).items():
            for s in arr.addressable_shards:
                coord = tuple(int(i) for i in
                              np.argwhere(m.devices == s.device)[0])
                res[f"{prefix}/{key}@{coord}"] = np.asarray(s.data)

    for name, (arch, shape, over, _) in CASES.items():
        cfg = _cfg(arch, over, "repro")
        m = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                 AXES)
        b = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"), m)
        step = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings)
        state = jax.device_put(
            jax.tree.map(np.asarray, b.init_fn(jax.random.key(0))),
            b.in_shardings[0])
        shards(f"{name}/init", state, m)
        src = SyntheticLM(cfg.vocab_size, S, seed=0)
        for i in range(STEPS):
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in src.batch(i, 0, B).items()},
                b.in_shardings[1])
            with m:
                state, mt = step(state, batch)
            res[f"{name}/loss{i}"] = np.asarray(mt["loss"])
            shards(f"{name}/step{i}", state, m)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port, one gloo rank per process
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import jax
    import torch
    import torch.distributed as dist
    from repro.configs.base import ShapeCfg as JShape
    from repro.train import make_step_bundle as jbundle
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.collectives import vocab_parallel_ce
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import from_jax_state, to_jax_state
    from repro_torch.train import load_state, make_step_bundle
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.steps import full_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}

    def init_state(bundle, arch, over):
        jcfg = _cfg(arch, over, "repro")
        jstate = jbundle(jcfg, JShape("t", S, B, "train")).init_fn(
            jax.random.key(0))
        state = bundle.init_fn(torch.Generator().manual_seed(0))
        load_state(state, from_jax_state(bundle.cfg,
                                         jax.tree.map(np.asarray, jstate)))
        return state

    def batches(cfg):
        src = SyntheticLM(cfg.vocab_size, S, seed=0)
        return lambda i: {k: torch.from_numpy(v) for k, v in
                          src.batch(i, 0, B).items()}

    def chunks(prefix, state, bundle):
        """This rank's local chunks in the reference's layout."""
        local = {"params": {k: p.to_local() for k, p in
                            state["params"].named_parameters()},
                 "opt": {part: {k: t.to_local() for k, t in
                                state["opt"][part].items()}
                         for part in ("m", "v")}}
        local["opt"]["step"] = state["opt"]["step"].to_local()
        coord = tuple(bundle.mesh.get_coordinate())
        for key, t in _flat(to_jax_state(bundle.cfg, local)).items():
            res[f"{prefix}/{key}@{coord}"] = t.numpy()

    class record_views:
        """Each leaf's compute view in a step: (its elements, the leaf's
        elements, the placements asked for)."""

        def __init__(self, state):
            self.keys = {id(p): k for k, p in
                         state["params"].named_parameters()}
            self.seen = {}

        def __enter__(self):
            self.saved = steps_mod.view_as

            def view_as(t, placements=None):
                out = self.saved(t, placements)
                if id(t) in self.keys:
                    self.seen[self.keys[id(t)]] = (
                        out.numel(), t.numel(),
                        [repr(p) for p in placements or ()])
                return out

            steps_mod.view_as = view_as
            return self

        def __exit__(self, *exc):
            steps_mod.view_as = self.saved

    for name, (arch, shape, over, _) in CASES.items():
        cfg = _cfg(arch, over, "repro_torch")
        bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"),
                                  make_mesh(shape, AXES, "cpu"))
        if bundle.mesh.get_coordinate() is None:
            continue
        res[f"{name}/kinds"] = np.array(json.dumps(sorted(bundle.tp.kinds)))
        res[f"{name}/tp_leaves"] = np.array(json.dumps(sorted(
            bundle.tp.views)))
        state = init_state(bundle, arch, over)
        chunks(f"{name}/init", state, bundle)
        get = batches(cfg)
        for i in range(STEPS):
            with record_views(state) as rec:
                state, mt = bundle.step_fn(state, get(i))
            res[f"{name}/views{i}"] = np.array(json.dumps(rec.seen))
            res[f"{name}/loss{i}"] = mt["loss"].numpy()
            res[f"{name}/step_count{i}"] = mt["step"].numpy()
            chunks(f"{name}/step{i}", state, bundle)

    # --- the vocab-parallel cross-entropy on the (1, 2) mesh's ranks ---------
    m12 = make_mesh((1, 2), AXES, "cpu")
    if m12.get_coordinate() is not None:
        logits, labels = (torch.from_numpy(a) for a in _ce_inputs())
        V_l = CE_VOCAB // 2
        lo = m12.get_local_rank("model") * V_l
        mine = logits[..., lo:lo + V_l].clone().requires_grad_()
        ce = vocab_parallel_ce(mine, labels, lo, m12.get_group("model"))
        g = torch.linspace(0.5, 1.5, ce.numel()).reshape(ce.shape)
        res["ce/loss"] = ce.detach().numpy()
        res["ce/grad"] = torch.autograd.grad(ce, mine, g)[0].numpy()

    # --- one rank: the plan's code, its collectives identities ---------------
    m11 = make_mesh((1, 1), AXES, "cpu")
    if m11.get_coordinate() is not None:
        for name in ONE_RANK:
            arch, _, over, _ = CASES[name]
            cfg = _cfg(arch, over, "repro_torch")
            shape = ShapeCfg("t", S, B, "train")
            bundles = (make_step_bundle(cfg, shape, m11),
                       make_step_bundle(cfg, shape))
            states = [init_state(b, arch, over) for b in bundles]
            get = batches(cfg)
            equal = []
            for i in range(STEPS):
                outs = [b.step_fn(st, get(i)) for b, st in
                        zip(bundles, states)]
                (mesh_state, a), (plain_state, b) = outs
                equal.append(("loss", bool(torch.equal(a["loss"],
                                                       b["loss"]))))
                mesh_full = _flat(full_state(mesh_state))
                plain_full = _flat(full_state(plain_state))
                equal += [(k, bool(torch.equal(mesh_full[k], plain_full[k])))
                          for k in plain_full]
            res[f"one/{name}/kinds"] = np.array(json.dumps(sorted(
                bundles[0].tp.kinds)))
            res[f"one/{name}/equal"] = np.array(json.dumps(equal))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return run_sides(tmp_path_factory.mktemp("tp"), "test_torch_tp", 4, 4,
                     TIMEOUT)


def _in_mesh(ranks, name):
    n = math.prod(CASES[name][1])
    return ranks[:n]


@pytest.mark.parametrize("name", list(CASES))
def test_tp_losses_match_reference(sides, name):
    ref, ranks = sides
    for got in _in_mesh(ranks, name):
        for i in range(STEPS):
            np.testing.assert_allclose(got[f"{name}/loss{i}"],
                                       ref[f"{name}/loss{i}"], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_chunks_match_reference_shards(sides, name):
    ref, ranks = sides
    got_ranks = _in_mesh(ranks, name)
    for got in got_ranks:
        keys = [k for k in got if k.startswith(f"{name}/init/")]
        coord = keys[0].split("@")[1]
        assert sorted(keys) == sorted(
            k for k in ref if k.startswith(f"{name}/init/")
            and k.split("@")[1] == coord)
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(ref, got_ranks, name, i, prev, _lr(i + 1))
    coords = sorted(next(k for k in got if k.startswith(f"{name}/step0/"))
                    .split("@")[1] for got in got_ranks)
    assert coords == sorted({k.split("@")[1] for k in ref
                             if k.startswith(f"{name}/step0/")})


@pytest.mark.parametrize("name", list(CASES))
def test_tp_views_are_model_chunks(sides, name):
    """The plan splits the kinds the config's counts allow; every leaf of
    those kinds computes on a view of 1/m of its elements, asked for with
    ``Shard`` on ``model``; every other leaf whole (or its experts)."""
    _, ranks = sides
    arch, shape, over, kinds = CASES[name]
    m = shape[AXES.index("model")]
    for got in _in_mesh(ranks, name):
        assert json.loads(str(got[f"{name}/kinds"])) == sorted(kinds)
        tp_leaves = json.loads(str(got[f"{name}/tp_leaves"]))
        for i in range(STEPS):
            views = json.loads(str(got[f"{name}/views{i}"]))
            want = sorted(k for k in views if any(
                k.endswith(end) for kind in kinds
                for end in KIND_LEAVES[kind]))
            assert tp_leaves == want and want
            for key, (local, whole, placements) in views.items():
                if key in tp_leaves:
                    assert local * m == whole, (key, local, whole)
                    assert placements[AXES.index("model")].startswith(
                        "Shard"), (key, placements)
                elif ".ffn." in key and "ep_shard" in over:
                    assert local * m == whole, key      # this rank's experts
                else:
                    assert local == whole, key


def test_vocab_parallel_ce_matches_logsumexp(sides):
    import torch
    _, ranks = sides
    logits, labels = (torch.from_numpy(a) for a in _ce_inputs())
    x = logits.clone().requires_grad_()
    want = torch.logsumexp(x, -1) - torch.gather(x, -1, labels[..., None])[
        ..., 0]
    g = torch.linspace(0.5, 1.5, want.numel()).reshape(want.shape)
    grad = torch.autograd.grad(want, x, g)[0].numpy()
    for r, got in enumerate(ranks[:2]):
        np.testing.assert_allclose(got["ce/loss"], want.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        V_l = CE_VOCAB // 2
        np.testing.assert_allclose(got["ce/grad"],
                                   grad[..., r * V_l:(r + 1) * V_l],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_tp_equals_plain_step(sides, name):
    """On a (1, 1) mesh the plan splits every kind present and the same
    code runs with its collectives as identities: two steps equal the
    mesh-free step's loss, parameters and moments bit for bit."""
    _, ranks = sides
    got = ranks[0]
    assert json.loads(str(got[f"one/{name}/kinds"])) == sorted(ALL)
    equal = json.loads(str(got[f"one/{name}/equal"]))
    assert len(equal) > 3 * STEPS
    assert [k for k, ok in equal if not ok] == []


# ---------------------------------------------------------------------------
# The plan of the full configs (one process, no ranks)
# ---------------------------------------------------------------------------

# (arch, mesh shape over ("data", "model"), config changes, kinds split)
PLANS = [
    ("qwen2-7b", (16, 4), {}, ALL),                  # 28 heads, 4 KV
    ("qwen2-7b", (16, 8), {}, {"ffn", "vocab"}),     # 3.5 heads a rank
    ("gemma2-2b", (1, 2), {}, ALL),
    ("gemma2-2b", (16, 16), {}, {"ffn", "vocab"}),
    ("granite-34b", (16, 16), {}, {"heads", "ffn", "vocab"}),   # MQA
    ("granite-moe-3b-a800m", (16, 8), {}, {"heads", "kv_heads"}),
    ("granite-moe-3b-a800m", (1, 1), {}, {"heads", "kv_heads", "vocab"}),
    ("jamba-v0.1-52b", (16, 16), {}, {"heads", "ffn", "vocab"}),
    ("xlstm-125m", (16, 16), {}, {"vocab"}),
    ("qwen2-7b", (16, 4), {"seq_shard": True}, set()),
]


from torch.distributed.tensor import Replicate, Shard  # noqa: E402


def _plan(arch, shape, over, axes=AXES):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import resolve_axes_tree, tp_plan
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch), **over)
    shapes, param_axes = Model(cfg, device="meta").param_shapes()
    specs = resolve_axes_tree(param_axes, shapes, cfg, (axes, shape))
    return tp_plan(cfg, dict(zip(axes, shape)), param_axes, specs), shapes


@pytest.mark.parametrize("arch,shape,over,kinds", PLANS)
def test_tp_plan_of_full_configs(arch, shape, over, kinds):
    plan, shapes = _plan(arch, shape, over)
    assert plan.kinds == kinds
    # an MoE layer's expert leaves (E, ., .) are not the MLP's
    want = {k for k in shapes if shapes[k].dim() <= 2 and any(
        k.endswith(end) for kind in kinds for end in KIND_LEAVES[kind])}
    assert set(plan.views) == want
    m = shape[1]
    for key, d in plan.views.items():
        assert shapes[key].shape[d] % m == 0
        assert plan.placements(key, AXES) == [Replicate(), Shard(d)]
    if arch == "qwen2-7b" and not over:
        # 28 layers: wq bq wo (+ wk wv bk bv at m=4), the MLP, embeddings
        assert len(plan.views) == 28 * (10 if m == 4 else 3) + 2


def test_tp_plan_without_a_model_axis():
    plan, _ = _plan("qwen2-7b", (2, 2), {}, axes=("pod", "data"))
    assert plan.size == 0 and not plan.kinds and not plan.views


# (n_heads, n_kv_heads, ranks on "model"): query heads that split while
# their KV heads do not, with a uniform GQA grouping per rank or not
# (qwen2-7b's 28 over 4 on 7 ranks: rank 1's heads 4-7 read KV heads
# 0, 0, 0, 1)
KV_READ = [(4, 1, 2), (4, 2, 4), (6, 3, 2), (28, 4, 7), (24, 8, 12)]


@pytest.mark.parametrize("nh,nkv,m", KV_READ)
def test_local_query_heads_read_their_kv_heads(nh, nkv, m):
    """Each rank's attention output of its query heads, from its columns
    of ``wq``/``bq`` and the whole ``wk``/``wv``/``bk``/``bv``, equals
    those heads of the whole layer's output (forward, one process)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.distributed.sharding import TPRank
    from repro_torch.models import attention as A
    hd, d = 8, 16
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-7b")),
                              n_heads=nh, n_kv_heads=nkv, head_dim=hd,
                              d_model=d)
    g = torch.Generator().manual_seed(0)
    p = {n: torch.randn(shape, generator=g) for n, shape in (
        ("wq", (d, nh * hd)), ("wk", (d, nkv * hd)), ("wv", (d, nkv * hd)),
        ("bq", (nh * hd,)), ("bk", (nkv * hd,)), ("bv", (nkv * hd,)))}
    x = torch.randn((2, 8, d), generator=g)
    pos = torch.arange(8)[None, :]

    def attend(q, k, v):
        return A.full_attention(A.rope(q, pos, cfg.rope_theta),
                                A.rope(k, pos, cfg.rope_theta), v, cfg)

    whole = attend(*A._qkv(p, x, cfg, None))
    n = nh // m
    for r in range(m):
        local = dict(p, wq=p["wq"][:, r * n * hd:(r + 1) * n * hd],
                     bq=p["bq"][r * n * hd:(r + 1) * n * hd])
        q, k, v = A._qkv(local, x, cfg, TPRank(None, r))
        assert q.shape[2] == n and n % k.shape[2] == 0
        torch.testing.assert_close(attend(q, k, v),
                                   whole[:, :, r * n:(r + 1) * n])
