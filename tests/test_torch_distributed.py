"""Distribution in the port against the reference, on the CPU.

The reference runs in one subprocess on 4 forced CPU devices, with its
meshes built by ``jax.sharding.Mesh`` (``Auto`` axes; on this JAX,
``jax.make_mesh`` gives ``Explicit`` axes, on which the reference's own
mesh step fails: ROADMAP C8).  The port runs on 4 gloo ranks, one
subprocess each, meeting through a ``FileStore`` in ``tmp_path``; each
rank builds the reference's initial values with JAX on one device.  Each
side writes its numbers to an npz and the tests compare them here.

Cases (smoke granite-moe-3b-a800m: 4 experts top-2, d_model 128):

- expert-parallel ``moe_apply`` on a (2, 2) ``("data", "model")`` mesh,
  x (4, 16, 128), at capacity factors 0.5, 1.25 (the default: tokens
  drop at the local capacity) and 8.0: outputs, ``moe_aux``, ``moe_drop``
  and the gradient of sum(out**2) of every leaf against the reference's
  EP, and at 8.0 against its dense route too; the dense route on the
  mesh (``ep_shard`` off, rows gathered over ``data``) against the
  reference's dense route (at 0.5 tokens drop at the global capacity);
- the mesh train step, 2 steps at batch 8 x 32: (2, 2) with ``ep_shard``
  and 2 microbatches;
  (2, 1, 2) ``("pod", "data", "model")`` with int8 compression and 2
  microbatches; (2, 2, 1) with ``fsdp_params`` and 2 microbatches
  (d_model split over ``("pod", "data")``, the dense MoE route over the
  rows of 4 ranks).  Each
  rank's local chunks are held against the reference's shards at the
  same mesh coordinate, the initial state exactly;
- ``act_constrain`` on DTensors (a resolved dim, and one whose rule
  fails divisibility and keeps its placement);
- ``restore_tree`` onto the bundle's placements, a failure restored by
  the driver on the mesh, and ``rescale`` of the (2, 2) state to (4, 1)
  and to a (1, 2) mesh of 2 ranks, each followed by the reference's next
  step after the same rescale.

Tolerances (``tests/test_torch_optim.py``'s and ``test_torch_moe.py``'s):
losses rtol 1e-5; moments rtol 2e-4 with atol 2e-4 of the part's largest
entry; parameter deltas within one float32 step of the parameter on each
side plus 1e-3 of the step's learning rate, where the gradient is
resolved; MoE outputs and gradients rtol = atol = 2e-5 of each leaf's
largest entry; aux and drop rtol 1e-6.  Under int8 compression the
error feedback is held at atol 2e-4 of its gradient's scale (127 int8
steps), and a gradient entry within float32 noise of a rounding boundary
may quantize to the neighbouring int8 value on one side (a few entries in
10**5 were seen): in at most 1 entry in 1000, the averaged gradient may
then move by one int8 step of a pod's scale per step, so m by 0.1 of the
steps' scales / pods, v by 0.001 of (2 * 127 + 1) scale**2 / pods, and
the error feedback by the scales' sum, and such an entry's parameter
delta, which follows its own moments, is not held.  A scale is estimated
from the reference's error feedback (``_quanta``).
"""
import json
import math
import os

import numpy as np
import pytest

from _torch_ranks import run_sides

ARCH = "granite-moe-3b-a800m"
B, S, STEPS = 8, 32, 2
X_SHAPE = (4, 16, 128)
CAPS = (0.5, 1.25, 8.0)
# name: (mesh shape, axes, config changes)
TRAIN = {
    "ep22": ((2, 2), ("data", "model"), dict(ep_shard=True,
                                             microbatches=2)),
    "int8": ((2, 1, 2), ("pod", "data", "model"),
             dict(grad_compression="int8", microbatches=2)),
    # d_model split over ("pod", "data"): the chunk order of two axes on
    # one dim.  The dense MoE route routes each global microbatch, its
    # rows gathered over both axes: microbatch i is rows 4i .. 4i + 3, one
    # per rank, not each rank's own two rows split in two (the capacity
    # and the aux term see which rows go together)
    "fsdp": ((2, 2, 1), ("pod", "data", "model"),
             dict(fsdp_params=True, microbatches=2)),
}
RESCALE = {"r41": (4, 1), "r12": (1, 2)}   # with one microbatch
ONE_MB = dict(TRAIN["ep22"][2], microbatches=1)
TIMEOUT = 420


def _cfg(over: dict, pkg: str):
    import dataclasses
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    cfg = mod.reduce_for_smoke(mod.get_config(ARCH))
    moe = {k: v for k, v in over.items() if k in ("ep_shard",
                                                  "capacity_factor")}
    rest = {k: v for k, v in over.items() if k not in moe}
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **moe), **rest)


def _x():
    return np.random.default_rng(0).normal(0, 1, X_SHAPE).astype(np.float32)


def _flat(tree, prefix=""):
    """{'a/b/c': leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# The reference, on 4 forced devices
# ---------------------------------------------------------------------------


def ref_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLM
    from repro.distributed.sharding import activation_sharding
    from repro.models import moe as moe_mod
    from repro.models.params import unzip
    from repro.train import make_step_bundle

    assert jax.device_count() == 4, jax.devices()
    res = {}

    def mesh(shape, axes):
        n = math.prod(shape)
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    # --- moe_apply ---------------------------------------------------------
    cfg = _cfg({}, "repro")
    params = unzip(moe_mod.init_moe(jax.random.key(0), cfg))[0]
    x = jnp.asarray(_x())
    m22 = mesh((2, 2), ("data", "model"))
    for cap in CAPS:
        for route in ("ep", "dense"):
            c = _cfg(dict(capacity_factor=cap, ep_shard=route == "ep"),
                     "repro")

            def f(p, c=c, route=route):
                if route == "dense":
                    return moe_mod._moe_apply_dense(p, x, c)
                with activation_sharding(m22, c):
                    return moe_mod.moe_apply(p, x, c)

            def loss(p, f=f):
                return jnp.sum(f(p)[0].astype(jnp.float32) ** 2)

            with m22:
                out, aux = jax.jit(f)(params)
                g = jax.jit(jax.grad(loss))(params)
            tag = f"moe/{route}/{cap}"
            res[f"{tag}/out"] = np.asarray(out)
            res[f"{tag}/aux"] = np.asarray(aux["moe_aux"])
            res[f"{tag}/drop"] = np.asarray(aux["moe_drop"])
            for k, v in g.items():
                res[f"{tag}/grad/{k}"] = np.asarray(v)

    # --- the mesh train step ------------------------------------------------
    def shards(prefix, state, m):
        for key, arr in _flat(jax.tree.map(lambda a: a, state)).items():
            for s in arr.addressable_shards:
                coord = tuple(int(i) for i in
                              np.argwhere(m.devices == s.device)[0])
                res[f"{prefix}/{key}@{coord}"] = np.asarray(s.data)

    def run(cfg, m, state, steps, tag):
        b = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"), m)
        step = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings)
        if state is None:
            state = b.init_fn(jax.random.key(0))
        state = jax.device_put(jax.tree.map(np.asarray, state),
                               b.in_shardings[0])
        shards(f"{tag}/init", state, m)
        src = SyntheticLM(cfg.vocab_size, S, seed=0)
        for i in steps:
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in src.batch(i, 0, B).items()},
                b.in_shardings[1])
            with m:
                state, mt = step(state, batch)
            res[f"{tag}/loss{i}"] = np.asarray(mt["loss"])
            shards(f"{tag}/step{i}", state, m)
        return state

    # ROADMAP C9: with compression, ``accumulate``'s microbatch constraint
    # (the only ``batch_spec(mesh, 0)``) names the manual "pod" axis
    # inside the pod region, which this JAX refuses.  A constraint moves
    # no value, so the run drops "pod" from it (test code only).
    import repro.train.steps as jsteps
    from jax.sharding import PartitionSpec as JP
    spec_of = jsteps.batch_spec
    jsteps.batch_spec = lambda mesh, extra_dims=1, batch_size=None: (
        JP(tuple(a for a in spec_of(mesh, 0)[0] if a != "pod"))
        if extra_dims == 0 and "pod" in mesh.axis_names
        else spec_of(mesh, extra_dims, batch_size))

    for name, (shape, axes, over) in TRAIN.items():
        m = mesh(shape, axes)
        state = run(_cfg(over, "repro"), m, None, range(STEPS), name)
        if name == "ep22":
            for r, shape2 in RESCALE.items():
                run(_cfg(ONE_MB, "repro"), mesh(shape2, ("data", "model")),
                    state, [STEPS], r)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port, one gloo rank per process
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import dataclasses
    import jax
    import torch
    import torch.distributed as dist
    from repro.configs.base import ShapeCfg as JShape
    from repro.models import moe as jmoe
    from repro.models.params import unzip
    from repro.train import make_step_bundle as jbundle
    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (
        act_constrain, activation_sharding, local_chunk,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import (
        from_jax_state, to_jax_params, to_jax_state,
    )
    from repro_torch.runtime import ElasticTrainer
    from repro_torch.train import load_state, make_step_bundle
    from repro_torch.train.steps import full_state
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}

    # --- moe_apply on (2, 2) ------------------------------------------------
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    d, mi = m22.get_coordinate()
    cfg = _cfg({}, "repro_torch")
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in unzip(
        jmoe.init_moe(jax.random.key(0), _cfg({}, "repro")))[0].items()}
    E_l = cfg.moe.padded_experts() // 2
    x = torch.from_numpy(_x())[d * 2:(d + 1) * 2]
    for cap in CAPS:
        for route in ("ep", "dense"):
            c = _cfg(dict(capacity_factor=cap, ep_shard=route == "ep"),
                     "repro_torch")
            if route == "ep":
                p = {k: (v[:, mi * E_l:(mi + 1) * E_l] if k == "router" else
                         v[mi * E_l:(mi + 1) * E_l]) for k, v in full.items()}
            else:
                p = dict(full)
            p = {k: v.clone().requires_grad_() for k, v in p.items()}
            with activation_sharding(m22, c):
                out, aux = moe.moe_apply(p, x, c)
            grads = torch.autograd.grad((out.float() ** 2).sum(),
                                        list(p.values()))
            tag = f"moe/{route}/{cap}"
            res[f"{tag}/out"] = out.detach().numpy()
            res[f"{tag}/aux"] = aux["moe_aux"].detach().numpy()
            res[f"{tag}/drop"] = aux["moe_drop"].numpy()
            for k, g in zip(p, grads):
                # the loss is the sum of the ranks' rows: add over data
                dist.all_reduce(g, group=m22.get_group("data"))
                res[f"{tag}/grad/{k}"] = g.numpy()

    # --- act_constrain on DTensors ------------------------------------------
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with activation_sharding(m22, cfg):
        # dim 1 resolves to "data"
        a = act_constrain(distribute_tensor(
            torch.arange(24.).reshape(4, 6), m22, [Shard(0), Replicate()]),
            (None, "act_batch"))
        # "heads" cannot split 3 over "model": the dim keeps its placement
        b = act_constrain(distribute_tensor(
            torch.arange(12.).reshape(4, 3), m22, [Replicate(), Shard(1)]),
            ("act_batch", "heads"))
    res["act_constrain"] = np.array(json.dumps(
        [[repr(p) for p in t.placements] for t in (a, b)]
        + [a.full_tensor().tolist(), b.full_tensor().tolist()]))

    # --- the mesh train step ------------------------------------------------
    def chunks(prefix, state, bundle):
        """This rank's local chunks in the checkpoint's layout (a stacked
        leaf: the groups' chunks stacked), keyed like the reference's."""
        local = {"params": {k: p.to_local() for k, p in
                            state["params"].named_parameters()},
                 "opt": {"m": {k: t.to_local() for k, t in
                               state["opt"]["m"].items()},
                         "v": {k: t.to_local() for k, t in
                               state["opt"]["v"].items()},
                         "step": state["opt"]["step"].to_local()}}
        if "ef" in state:
            local["ef"] = {k: t.to_local() for k, t in state["ef"].items()}
        tree = to_jax_state(bundle.cfg, local)
        coord = tuple(bundle.mesh.get_coordinate())
        for key, t in _flat(tree).items():
            res[f"{prefix}/{key}@{coord}"] = t.numpy()

    def bundle_on(shape, axes, over):
        c = _cfg(over, "repro_torch")
        return make_step_bundle(c, ShapeCfg("t", S, B, "train"),
                                make_mesh(shape, axes, "cpu"))

    def batches(cfg):
        src = SyntheticLM(cfg.vocab_size, S, seed=0)
        return lambda i: {k: torch.from_numpy(v) for k, v in
                          src.batch(i, 0, B).items()}

    def init_state(bundle, over):
        jcfg = _cfg(over, "repro")
        jstate = jbundle(jcfg, JShape("t", S, B, "train")).init_fn(
            jax.random.key(0))
        state = bundle.init_fn(torch.Generator().manual_seed(0))
        tree = from_jax_state(bundle.cfg, jax.tree.map(np.asarray, jstate))
        if "ef" in state:       # the reference makes it on a mesh only
            tree["ef"] = {k: torch.zeros(v.shape)
                          for k, v in tree["params"].items()}
        load_state(state, tree)
        return state

    for name, (shape, axes, over) in TRAIN.items():
        bundle = bundle_on(shape, axes, over)
        state = init_state(bundle, over)
        chunks(f"{name}/init", state, bundle)
        get = batches(bundle.cfg)
        for i in range(STEPS):
            state, mt = bundle.step_fn(state, get(i))
            res[f"{name}/loss{i}"] = mt["loss"].numpy()
            res[f"{name}/step_count{i}"] = mt["step"].numpy()
            chunks(f"{name}/step{i}", state, bundle)
        if name != "ep22":
            continue

        # restore_tree onto the bundle's placements
        ckpt = os.path.join(out_dir, "ckpt")
        tree = to_jax_state(bundle.cfg, state)
        if rank == 0:
            save_tree(tree, ckpt)
        dist.barrier()
        back = restore_tree(ckpt, to_jax_state(bundle.cfg, state, "meta"),
                            to_jax_state(bundle.cfg, bundle.in_shardings[0]))
        ok = True
        for key, t in _flat(back).items():
            want = _flat(to_jax_state(bundle.cfg, bundle.in_shardings[0]))[key]
            ok &= isinstance(t, DTensor) and list(t.placements) == \
                list(want.placements) and torch.equal(
                    t.to_local(), local_chunk(_flat(tree)[key], bundle.mesh,
                                              want.placements))
        res["restore_tree_ok"] = np.array(ok)

        # a failure at step 1 restored by the driver on the mesh
        trainer = ElasticTrainer(bundle, batches(bundle.cfg),
                                 ckpt_dir=os.path.join(out_dir, "driver"),
                                 ckpt_every=1, log_fn=lambda s: None)
        trainer.inject_failure(at_step=1)
        trainer.run(init_state(bundle, over), steps=STEPS)
        res["driver/losses"] = np.array(trainer.report.losses)
        res["driver/restarts"] = np.array(trainer.report.restarts)

        # rescale to (4, 1), then to (1, 2) on ranks 0 and 1
        before = full_state(state)
        for r, shape2 in RESCALE.items():
            new_bundle = bundle_on(shape2, ("data", "model"), ONE_MB)
            new = trainer.rescale(new_bundle, state)
            res[f"{r}/event"] = np.array(json.dumps(
                trainer.report.events[-1]))
            if new is None:
                res[f"{r}/outside"] = np.array(True)
                continue
            after = full_state(new)
            res[f"{r}/unchanged"] = np.array(all(
                torch.equal(a, b) for a, b in zip(_flat(after).values(),
                                                  _flat(before).values())))
            new, mt = new_bundle.step_fn(new, get(STEPS))
            res[f"{r}/loss{STEPS}"] = mt["loss"].numpy()
            chunks(f"{r}/step{STEPS}", new, new_bundle)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return run_sides(tmp_path_factory.mktemp("dist"),
                     "test_torch_distributed", 4, 4, TIMEOUT)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _close(got, want, rel=2e-5, msg=""):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=msg)


COORDS = [(0, 0), (0, 1), (1, 0), (1, 1)]     # rank r's (data, model)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("route", ["ep", "dense"])
def test_moe_outputs_match_reference(sides, route, cap):
    ref, ranks = sides
    tag = f"moe/{route}/{cap}"
    for r, (d, m) in enumerate(COORDS):
        got = ranks[r]
        _close(got[f"{tag}/out"], ref[f"{tag}/out"][d * 2:(d + 1) * 2],
               msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{tag}/aux"], ref[f"{tag}/aux"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got[f"{tag}/drop"], ref[f"{tag}/drop"],
                                   rtol=1e-6)
    if cap == 0.5 or (cap == 1.25 and route == "ep"):
        assert float(ref[f"{tag}/drop"]) > 0, "no token dropped"


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("route", ["ep", "dense"])
def test_moe_grads_match_reference(sides, route, cap):
    ref, ranks = sides
    tag = f"moe/{route}/{cap}"
    keys = [k.split("/")[-1] for k in ref if k.startswith(f"{tag}/grad/")]
    assert {"router", "w_up", "w_down"} <= set(keys)
    E_l = ref[f"{tag}/grad/w_up"].shape[0] // 2
    for r, (_, m) in enumerate(COORDS):
        for k in keys:
            want = ref[f"{tag}/grad/{k}"]
            if route == "ep":
                want = (want[:, m * E_l:(m + 1) * E_l] if k == "router"
                        else want[m * E_l:(m + 1) * E_l])
            _close(ranks[r][f"{tag}/grad/{k}"], want, msg=f"rank {r} {k}")


def test_moe_ep_equals_dense_at_high_capacity(sides):
    """At capacity 8.0 nothing drops: the port's EP route equals the
    reference's dense route, outputs and every gradient leaf."""
    ref, ranks = sides
    assert float(ref["moe/dense/8.0/drop"]) == 0.0
    for r, (d, m) in enumerate(COORDS):
        _close(ranks[r]["moe/ep/8.0/out"],
               ref["moe/dense/8.0/out"][d * 2:(d + 1) * 2])
        E_l = ref["moe/dense/8.0/grad/w_up"].shape[0] // 2
        for k in ("router", "w_up", "w_gate", "w_down"):
            want = ref[f"moe/dense/8.0/grad/{k}"]
            want = (want[:, m * E_l:(m + 1) * E_l] if k == "router"
                    else want[m * E_l:(m + 1) * E_l])
            _close(ranks[r][f"moe/ep/8.0/grad/{k}"], want, msg=k)


# ---------------------------------------------------------------------------
# The mesh train step
# ---------------------------------------------------------------------------


def _coords(ref, prefix):
    return sorted({k.split("@")[1] for k in ref if k.startswith(prefix)})


def _quanta(ref, name, i, leaf):
    """Estimates of the int8 scale of ``leaf``'s gradient at steps 0..i:
    twice the largest error feedback the reference kept (|ef| <= scale/2,
    and over a leaf's entries the largest comes within a few per cent of
    it), with a margin of 1.25."""
    return [2.5 * max(float(np.abs(ref[k]).max()) for k in ref
                      if k.startswith(f"{name}/step{j}/ef/{leaf}@"))
            for j in range(i + 1)]


def _state_parts(ref, got, tag, coord):
    """(m, v, ef): {leaf: (port chunk, reference shard, ok mask)} at
    ``tag``, ok at the plain tolerances (m and v: rtol 2e-4, atol 2e-4 of
    the part's largest entry; ef: atol 2e-4 of 127 int8 steps)."""
    name, i = tag.split("/step")
    out = {}
    for part, pre in (("m", "opt/m/"), ("v", "opt/v/"), ("ef", "ef/")):
        keys = [k for k in ref if k.startswith(f"{tag}/{pre}")]
        if not keys:
            continue
        scale = max(float(np.abs(ref[k]).max()) for k in keys)
        out[part] = {}
        for k in keys:
            if not k.endswith(f"@{coord}"):
                continue
            leaf = k[len(tag) + 1 + len(pre):].split("@")[0]
            a, w = got[k], ref[k]
            if part == "ef":
                q = _quanta(ref, name, int(i), leaf)
                ok = np.isclose(a, w, rtol=0, atol=2e-4 * 127 * q[-1])
            else:
                ok = np.isclose(a, w, rtol=2e-4, atol=2e-4 * scale)
            out[part][leaf] = (a, w, ok)
    return out


def _hold_step(ref, ranks, name, i, prev_tag, lr, pods=0,
               state_parts=None, reach=None):
    """Each rank's chunks after step ``i`` against the reference's shards
    at its coordinate (moments, error feedback, then the parameter deltas
    from ``prev_tag``).  ``pods``: int8 compression over that many pods,
    where at most 1 entry in 1000 may have flipped to the neighbouring
    int8 value at some step (see the module doc).  ``state_parts``: the
    moments' check, :func:`_state_parts` by default.  ``reach``: where
    ``ref`` is the same function summed in another order (a mesh-free
    step), each parameter's spread under reordered sums at each step
    (keyed as ``ref``; ``tests/_torch_rounding.py``): a delta's bar then
    also allows twice the spreads of the parameter before and after."""
    state_parts = state_parts or _state_parts
    tag = f"{name}/step{i}"
    for got in ranks:
        if not any(k.startswith(tag + "/") for k in got):
            continue
        coord = next(k for k in got if k.startswith(tag + "/")).split("@")[1]
        at = lambda pre, key, src: src[f"{pre}/{key}@{coord}"]
        keys = sorted({k[len(tag) + 1:].split("@")[0] for k in got
                       if k.startswith(tag + "/")})
        assert keys == sorted({k[len(tag) + 1:].split("@")[0] for k in ref
                               if k.startswith(tag + "/")})
        flipped = {}            # leaf: the entries an int8 flip moved
        for j in range(i + 1):
            for part, leaves in state_parts(ref, got, f"{name}/step{j}",
                                            coord).items():
                for leaf, (a, w, ok) in leaves.items():
                    if ok.all():
                        continue
                    assert pods, (name, j, part, leaf, coord,
                                  float(np.abs(a - w).max()))
                    q = _quanta(ref, name, j, leaf)
                    moved = {"m": 0.1 * sum(q) / pods,
                             "v": 1e-3 * sum(255 * s * s for s in q) / pods,
                             "ef": sum(q)}[part]
                    assert (~ok).mean() <= 1e-3, (part, leaf, (~ok).mean())
                    assert (np.abs(a - w)[~ok] <= moved).all(), \
                        (name, j, part, leaf, coord)
                    flipped[leaf] = flipped.get(leaf, False) | ~ok
        assert int(got[f"{name}/step_count{i}"]) == i + 1
        m_max = max(float(np.abs(ref[k]).max()) for k in ref
                    if k.startswith(f"{tag}/opt/m/"))
        for key in [k for k in keys if k.startswith("params/")]:
            p, w = at(tag, key, got), at(tag, key, ref)
            p0, w0 = at(prev_tag, key, got), at(prev_tag, key, ref)
            eps = np.finfo(p.dtype).eps
            tol = eps * (np.maximum(np.abs(p0), np.abs(p))
                         + np.maximum(np.abs(w0), np.abs(w))) + 1e-3 * lr
            if reach is not None:
                tol = tol + 2 * (reach[f"{tag}/{key}@{coord}"] + reach.get(
                    f"{prev_tag}/{key}@{coord}", 0))
            err = np.abs((p - p0) - (w - w0))
            leaf = key[len("params/"):]
            resolved = np.abs(at(tag, "opt/m/" + leaf, ref)) \
                >= 20 * 2e-4 * m_max
            if leaf in flipped:
                # an entry whose gradient flipped steps by its own moments
                resolved &= ~flipped[leaf]
            assert (err <= tol)[resolved].all(), (name, i, key, coord)


def _lr(step):
    return 3e-4 * step / 2000          # the reference's warmup


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_losses_match_reference(sides, name):
    ref, ranks = sides
    for i in range(STEPS):
        for got in ranks:
            np.testing.assert_allclose(got[f"{name}/loss{i}"],
                                       ref[f"{name}/loss{i}"], rtol=1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_chunks_match_reference_shards(sides, name):
    ref, ranks = sides
    # the initial state is the reference's, placed as the reference places
    # it: each rank's chunks are the reference's shards at its coordinate
    for got in ranks:
        keys = [k for k in got if k.startswith(f"{name}/init/")]
        assert keys and sorted(keys) == sorted(
            k for k in ref if k.startswith(f"{name}/init/")
            and k.split("@")[1] == keys[0].split("@")[1])
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(ref, ranks, name, i, prev, _lr(i + 1),
                   pods=TRAIN[name][0][0] if name == "int8" else 0)
    # every coordinate of the mesh appears once
    coords = [next(k for k in got if k.startswith(f"{name}/step0/"))
              .split("@")[1] for got in ranks]
    assert sorted(coords) == _coords(ref, f"{name}/step0/")


def test_act_constrain_redistributes_dtensors(sides):
    _, ranks = sides
    for got in ranks:
        a, b, va, vb = json.loads(str(got["act_constrain"]))
        assert a == ["Shard(dim=1)", "Replicate()"]     # data, model
        assert b == ["Shard(dim=0)", "Shard(dim=1)"]
        assert va == np.arange(24.).reshape(4, 6).tolist()
        assert vb == np.arange(12.).reshape(4, 3).tolist()


def test_restore_tree_places_on_the_bundle_mesh(sides):
    _, ranks = sides
    assert all(bool(got["restore_tree_ok"]) for got in ranks)


def test_driver_restores_a_failure_on_the_mesh(sides):
    ref, ranks = sides
    for got in ranks:
        assert int(got["driver/restarts"]) == 1
        losses = got["driver/losses"]
        np.testing.assert_allclose(losses, [ref[f"ep22/loss{i}"]
                                            for i in range(STEPS)],
                                   rtol=1e-5)


@pytest.mark.parametrize("r", list(RESCALE))
def test_rescale_keeps_values_and_next_loss(sides, r):
    ref, ranks = sides
    shape = RESCALE[r]
    n = math.prod(shape)
    for rank, got in enumerate(ranks):
        assert json.loads(str(got[f"{r}/event"])) == [
            "rescale", {"data": shape[0], "model": shape[1]}]
        if rank >= n:
            assert bool(got[f"{r}/outside"])
            continue
        assert bool(got[f"{r}/unchanged"])
        np.testing.assert_allclose(got[f"{r}/loss{STEPS}"],
                                   ref[f"{r}/loss{STEPS}"], rtol=1e-5)
