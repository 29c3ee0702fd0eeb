"""The prefill and decode step bundles on a mesh, against the reference.

The reference runs in one subprocess on 4 forced CPU devices, on meshes
built by ``jax.sharding.Mesh`` (``Auto`` axes, ROADMAP C8): its
``make_step_bundle`` prefill and decode functions, jitted with the
bundles' ``in_shardings`` and ``out_shardings``.  The port runs on 4 gloo
ranks (``_torch_ranks.run_sides``): each rank computes on its own chunks
through the tensor-parallel plan and holds its chunk of the cache, split
over ``model`` by KV heads or by sequence (``decode_cache_rules``).  Both
sides start from the reference's parameters (``init_params(key(0))``),
prefill B x S tokens, then take decode steps at positions ``DECODE_POS``
on the prefill's cache (a step at ``pos`` writes that position and
attends the keys up to it), with the same tokens.

Cases, smoke configs (d_model 128, 4 query heads of 32, float32), with
``cache_dtype="float32"`` and the changes listed, the same on both sides:

- qwen2-7b on (1, 4) ``("data", "model")``: its 4 KV heads split;
- qwen2-7b with 2 KV heads on (1, 4): ``cache_seq`` on ``model``, each
  rank holds 8 of the 32 positions of every KV head; at pos 13 two ranks
  hold no valid key;
- gemma2-2b with 1 KV head and its sliding window cut to 8 on (1, 4):
  ``cache_seq`` on ``model`` with the window, the softcaps and
  ``query_pre_attn_scalar``; every decode position lies past the window;
- qwen2-7b with ``fsdp_params`` on (2, 2): rows over ``data``, d_model of
  the weights over ``data``, KV heads over ``model``;
- jamba-v0.1-52b on (1, 2): the mamba mixers split by ``d_inner``
  channels, their caches (``inner`` on ``model``) read and written in
  place by each rank; the MoE layers by their experts;
- granite-moe-3b-a800m (4 experts top-2, no ``ep_shard``) on (1, 2) and
  (2, 2): each rank runs its experts at the capacity of the routed batch
  (on (2, 2) the rows gathered over ``data``);
- llama4-maverick-400b-a17b (4 experts top-1, MoE and dense layers) on
  (1, 2): the experts by experts, the shared expert by its ``d_ff``;
- xlstm-125m on (1, 2) and (1, 4): the mLSTM and sLSTM mixers split by
  heads, their caches (``inner`` and ``heads`` on ``model``) read and
  written in place, the sLSTM's post-FFN split at m=2 only;
- xlstm-125m with 2 heads on (1, 4): neither mixer splits (2 heads on 4
  ranks), so each computes whole on every rank: the mLSTM's conv cache,
  on ``model`` by ``inner``, is gathered for a decode step and written
  back by chunk.

Checks: each rank's logits rows and every cache chunk, after the prefill
and after each decode step, against the reference's values at the
rank's coordinate (float32 atol = rtol = 2e-5, the layer tolerance of
``tests/test_torch_models.py``; against the mesh-free model plus twice
each entry's spread under reordered sums, ``tests/_torch_rounding.py``);
the port's cache specs equal the
reference's decode cache specs; each chunk is its spec's share of the
cache (no rank holds a sequence-split cache whole); a decode step reads
the recurrent cache leaves of a split mixer in place (the tensors it
computes with are the leaves' own storage, which it writes) and issues
no all-gather of them, while a mixer left whole gathers its split
leaves; and on a (1, 1) mesh the bundles equal the mesh-free
``Model.prefill`` and ``Model.decode_step`` bit for bit.
"""
import json
import math
import os

import numpy as np
import pytest

from _torch_ranks import run_sides
from _torch_rounding import assert_within, spread

B, S = 4, 32
DECODE_POS = (13, 22, 31)
AXES = ("data", "model")
COMMON = dict(cache_dtype="float32")
# name: (arch, mesh shape, config changes, how the cache splits on model)
CASES = {
    "qwen2_kv": ("qwen2-7b", (1, 4), {}, "kv_heads"),
    "qwen2_seq": ("qwen2-7b", (1, 4), dict(n_kv_heads=2), "seq"),
    "gemma2_seq": ("gemma2-2b", (1, 4),
                   dict(n_kv_heads=1, sliding_window=8), "seq"),
    "qwen2_fsdp": ("qwen2-7b", (2, 2), dict(fsdp_params=True), "kv_heads"),
    "jamba": ("jamba-v0.1-52b", (1, 2), {}, "kv_heads"),
    "granite": ("granite-moe-3b-a800m", (1, 2), {}, "kv_heads"),
    "granite_22": ("granite-moe-3b-a800m", (2, 2), {}, "kv_heads"),
    "llama4": ("llama4-maverick-400b-a17b", (1, 2), {}, "kv_heads"),
    "xlstm_12": ("xlstm-125m", (1, 2), {}, "none"),
    "xlstm_14": ("xlstm-125m", (1, 4), {}, "none"),
    "xlstm_whole": ("xlstm-125m", (1, 4), dict(n_heads=2), "none"),
}
# the recurrent mixers split over "model": their caches are read in place
SPLIT_STATES = ("jamba", "xlstm_12", "xlstm_14")
# on (1, 1), bit for bit: {name: the kinds the plan splits there}
DENSE = ["ffn", "heads", "kv_heads", "vocab"]
ONE_RANK = {"qwen2_kv": DENSE, "gemma2_seq": DENSE,
            "jamba": sorted(DENSE + ["expert", "mamba"]),
            "xlstm_12": ["mlstm", "slstm", "slstm_ffn", "vocab"],
            "granite": ["expert", "heads", "kv_heads", "vocab"],
            "llama4": sorted(DENSE + ["expert", "shared"])}
TOL = 2e-5
# jamba's deep layers: the mesh-free port and the reference already differ
# by up to 5.7e-5 there (float32 sums of the mamba scan and the MoE in
# another order), so against the reference it is held at the whole-model
# bar of tests/test_torch_families.py; against the port's own mesh-free
# model every case is held at TOL
REF_TOL = {"jamba": 2e-4}
# xLSTM's deep layers likewise: the mesh-free port and the reference
# differ by up to 7e-5 in the mLSTM's C (43 of 65536 entries over 2e-5),
# and the split mixers' float32 sums in another order move the deep
# layers as far from the mesh-free model (up to 6e-5 in C at (1, 4),
# where the first layer's moved 3.6e-6): held against both at the
# whole-model bar of tests/test_torch_xlstm.py (2e-4, its logits and
# states against the reference); each split mixer is held to its whole
# layer at TOL by tests/test_torch_tp.py's layer test (ROADMAP C14)
REF_TOL.update({n: 2e-4 for n in ("xlstm_12", "xlstm_14", "xlstm_whole")})
PLAIN_TOL = {"xlstm_12": 2e-4, "xlstm_14": 2e-4}
TIMEOUT = 240


def _cfg(arch: str, over: dict, pkg: str):
    import dataclasses
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    return dataclasses.replace(mod.reduce_for_smoke(mod.get_config(arch)),
                               **COMMON, **over)


def _tokens(cfg):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (len(DECODE_POS), B, 1),
                         dtype=np.int32)
    return prompt, steps


def _spec_json(spec, ndim: int) -> str:
    """A spec as a list of per-dim parts (None, an axis, a list of axes),
    padded to ``ndim``."""
    parts = [list(p) if isinstance(p, tuple) else p for p in spec]
    return json.dumps(parts + [None] * (ndim - len(parts)))


# ---------------------------------------------------------------------------
# The reference, on 4 forced devices
# ---------------------------------------------------------------------------


def ref_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ShapeCfg
    from repro.train import make_step_bundle

    assert jax.device_count() == 4, jax.devices()
    res = {}

    def save(prefix, logits, cache, n_groups):
        res[f"{prefix}/logits"] = np.asarray(logits)
        for layer, tree in cache.items():
            for n, leaf in tree["mixer"].items():
                full = np.asarray(leaf)
                for g in range(n_groups):
                    res[f"{prefix}/{g}/{layer}/mixer/{n}"] = full[g]

    for name, (arch, shape, over, _) in CASES.items():
        cfg = _cfg(arch, over, "repro")
        m = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                 AXES)
        pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"), m)
        db = make_step_bundle(cfg, ShapeCfg("d", S, B, "decode"), m)
        params = jax.device_put(pb.model.init_params(jax.random.key(0)),
                                pb.in_shardings[0])
        prefill = jax.jit(pb.step_fn, in_shardings=pb.in_shardings,
                          out_shardings=pb.out_shardings)
        decode = jax.jit(db.step_fn, in_shardings=db.in_shardings,
                         out_shardings=db.out_shardings)
        prompt, steps = _tokens(cfg)
        with m:
            logits, cache = prefill(params, jnp.asarray(prompt))
        save(f"{name}/prefill", logits, cache, cfg.n_groups)
        for layer, tree in db.in_shardings[1].items():
            for n, sh in tree["mixer"].items():
                # the port's caches have no stacked "layers" dim
                ndim = len(cache[layer]["mixer"][n].shape) - 1
                res[f"{name}/spec/{layer}/{n}"] = np.array(_spec_json(
                    tuple(sh.spec)[1:], ndim))
        cache = jax.device_put(cache, db.in_shardings[1])
        for i, pos in enumerate(DECODE_POS):
            with m:
                logits, cache = decode(params, cache, jnp.asarray(steps[i]),
                                       jnp.int32(pos))
            save(f"{name}/decode{i}", logits, cache, cfg.n_groups)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port, one gloo rank per process
# ---------------------------------------------------------------------------


def _port_params(cfg, arch, over):
    """The reference's initial parameters, as full port values."""
    import jax
    import torch
    from repro.models import Model as JModel
    from repro_torch.models.params import from_jax_params
    tree = JModel(_cfg(arch, over, "repro")).init_params(jax.random.key(0))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            from_jax_params(cfg, jax.tree.map(np.asarray, tree)).items()}


def _plain_run(name):
    """A function that runs case ``name``'s mesh-free model, whole, from
    the reference's parameters: the prefill and the decode steps, their
    logits and caches as {"<stage>/...": array}."""
    import torch
    from repro_torch.models import Model
    arch, _, over, _ = CASES[name]
    cfg = _cfg(arch, over, "repro_torch")
    model = Model(cfg, device="cpu")
    model.load_state_dict(_port_params(cfg, arch, over))
    prompt, steps = _tokens(cfg)

    def arrays(stage, logits, cache):
        out = {f"{stage}/logits": logits.numpy().copy()}
        for g, gc in enumerate(cache):
            for layer, tree in gc.items():
                for n, leaf in tree["mixer"].items():
                    out[f"{stage}/{g}/{layer}/mixer/{n}"] = \
                        leaf.numpy().copy()
        return out

    def run():
        logits, cache = model.prefill(torch.from_numpy(prompt).long())
        out = arrays("prefill", logits, cache)
        for i, pos in enumerate(DECODE_POS):
            logits, cache = model.decode_step(
                cache, torch.from_numpy(steps[i]).long(), pos)
            out.update(arrays(f"decode{i}", logits, cache))
        return out

    return run


@pytest.fixture(scope="module")
def reach():
    """Per case, how far the mesh-free model's results move when their
    products sum in other orders (``_torch_rounding.spread``), whole;
    computed in this process once the ranks are done."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = spread(_plain_run(name))
        return cache[name]

    return get


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.sharding import aliases, distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.train import make_step_bundle
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.steps import place_params
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}

    class watch_states(TorchDispatchMode):
        """During one decode step: whether the tensors the step computes
        with (``_ServeMesh.compute_cache``) are each recurrent cache
        leaf's own local storage, whether the leaf keeps that storage,
        which leaves were gathered over the mesh (``view_as`` asked for a
        value that is not the leaf's own storage), whether any DTensor
        was redistributed, and which leaves' storage a collective read or
        wrote."""

        def __init__(self, cache):
            super().__init__()
            self.leaves = {f"{g}/{layer}/{n}": t for g, gc in
                           enumerate(cache) for layer, tree in gc.items()
                           for n, t in tree["mixer"].items()
                           if n not in ("k", "v")}
            self.ptrs = {k: t.to_local().data_ptr()
                         for k, t in self.leaves.items()}
            self.read, self.redistributed, self.touched = {}, set(), set()
            self.redistributions = 0

        def __enter__(self):
            self.saved = (steps_mod._ServeMesh.compute_cache,
                          DTensor.redistribute, steps_mod.view_as)
            ids = {id(t): k for k, t in self.leaves.items()}

            def compute_cache(sv, cache):
                out = self.saved[0](sv, cache)
                for k in self.leaves:
                    g, layer, n = k.split("/")
                    self.read[k] = (out[int(g)][layer]["mixer"][n]
                                    .data_ptr() == self.ptrs[k])
                return out

            def redistribute(dt, *a, **kw):
                self.redistributions += 1
                return self.saved[1](dt, *a, **kw)

            def view_as(t, placements=None):
                if id(t) in ids and not aliases(t, placements):
                    self.redistributed.add(ids[id(t)])
                return self.saved[2](t, placements)

            steps_mod._ServeMesh.compute_cache = compute_cache
            DTensor.redistribute = redistribute
            steps_mod.view_as = view_as
            return super().__enter__()

        def __exit__(self, *exc):
            (steps_mod._ServeMesh.compute_cache, DTensor.redistribute,
             steps_mod.view_as) = self.saved
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace in ("c10d", "_c10d_functional"):
                mine = {t.data_ptr() for t in tree_flatten((args, kwargs))[0]
                        if isinstance(t, torch.Tensor)}
                self.touched |= {k for k, p in self.ptrs.items()
                                 if p in mine}
            return func(*args, **(kwargs or {}))

        def report(self):
            return {"read_in_place": self.read,
                    "kept": {k: t.to_local().data_ptr() == self.ptrs[k]
                             for k, t in self.leaves.items()},
                    "redistributed": sorted(self.redistributed),
                    "redistributions": self.redistributions,
                    "touched": sorted(self.touched)}

    def save(prefix, logits, cache, coord):
        res[f"{prefix}/logits@{coord}"] = logits.to_local().numpy()
        for g, gc in enumerate(cache):
            for layer, tree in gc.items():
                for n, leaf in tree["mixer"].items():
                    res[f"{prefix}/{g}/{layer}/mixer/{n}@{coord}"] = \
                        leaf.to_local().numpy().copy()

    for name, (arch, shape, over, _) in CASES.items():
        cfg = _cfg(arch, over, "repro_torch")
        mesh = make_mesh(shape, AXES, "cpu")
        pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"), mesh)
        db = make_step_bundle(cfg, ShapeCfg("d", S, B, "decode"), mesh)
        if mesh.get_coordinate() is None:
            continue
        coord = json.dumps(list(mesh.get_coordinate()))
        full = _port_params(cfg, arch, over)
        params = place_params(cfg, full, pb.in_shardings[0])
        prompt, steps = _tokens(cfg)
        if rank == 0:       # the mesh-free model, whole
            for k, v in _plain_run(name)().items():
                res[f"{name}/plain/{k}"] = v
        logits, cache = pb.step_fn(params, torch.from_numpy(prompt).long())
        save(f"{name}/prefill", logits, cache, coord)
        res[f"{name}/kinds"] = np.array(json.dumps(sorted(db.tp.kinds)))
        for layer, tree in db.in_shardings[1][0].items():
            for n, sh in tree["mixer"].items():
                ndim = cache[0][layer]["mixer"][n].dim()
                res[f"{name}/spec/{layer}/{n}"] = np.array(
                    _spec_json(sh.spec, ndim))
        for i, pos in enumerate(DECODE_POS):
            with watch_states(cache) as w:
                logits, cache = db.step_fn(
                    params, cache, torch.from_numpy(steps[i]).long(), pos)
            res[f"{name}/states{i}"] = np.array(json.dumps(w.report()))
            save(f"{name}/decode{i}", logits, cache, coord)

    # --- one rank: the bundles against the mesh-free model, bit for bit ----
    m11 = make_mesh((1, 1), AXES, "cpu")
    if m11.get_coordinate() is not None:
        for name in ONE_RANK:
            arch, _, over, _ = CASES[name]
            cfg = _cfg(arch, over, "repro_torch")
            pb = make_step_bundle(cfg, ShapeCfg("p", S, B, "prefill"), m11)
            db = make_step_bundle(cfg, ShapeCfg("d", S, B, "decode"), m11)
            full = _port_params(cfg, arch, over)
            model = Model(cfg, device="cpu")
            model.load_state_dict(full)
            params = place_params(cfg, full, pb.in_shardings[0])
            prompt, steps = _tokens(cfg)
            toks = torch.from_numpy(prompt).long()
            a, cache = pb.step_fn(params, toks)
            b, plain = model.prefill(toks)
            equal = [("prefill", torch.equal(a.to_local(), b))]
            for i, pos in enumerate(DECODE_POS):
                t = torch.from_numpy(steps[i]).long()
                a, cache = db.step_fn(params, cache, t, pos)
                b, plain = model.decode_step(plain, t, pos)
                equal.append((f"decode{i}", torch.equal(a.to_local(), b)))
                equal += [(f"decode{i}/{g}/{layer}/{n}", torch.equal(
                    leaf.to_local(), plain[g][layer]["mixer"][n]))
                    for g, gc in enumerate(cache)
                    for layer, tree in gc.items()
                    for n, leaf in tree["mixer"].items()]
            # the bundle's compute views follow ``params``: a leaf updated
            # in place, then a leaf replaced by another
            t = torch.from_numpy(steps[-1]).long()
            new = torch.from_numpy(np.random.default_rng(1).standard_normal(
                model.final_norm.scale.shape).astype(np.float32))
            with torch.no_grad():
                params.final_norm.scale.to_local().mul_(0.5)
                model.final_norm.scale.mul_(0.5)
            a, cache = db.step_fn(params, cache, t, DECODE_POS[-1])
            b, plain = model.decode_step(plain, t, DECODE_POS[-1])
            equal.append(("updated", torch.equal(a.to_local(), b)))
            params.final_norm._parameters["scale"] = torch.nn.Parameter(
                distribute(new, pb.in_shardings[0]["final_norm.scale"]),
                requires_grad=False)
            with torch.no_grad():
                model.final_norm.scale.copy_(new)
            a, cache = db.step_fn(params, cache, t, DECODE_POS[-1])
            b, plain = model.decode_step(plain, t, DECODE_POS[-1])
            equal.append(("replaced", torch.equal(a.to_local(), b)))
            res[f"one/{name}/kinds"] = np.array(json.dumps(sorted(
                pb.tp.kinds)))
            res[f"one/{name}/equal"] = np.array(json.dumps(equal))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return run_sides(tmp_path_factory.mktemp("serve"),
                     "test_torch_serve_bundles", 4, 4, TIMEOUT)


def _chunk(full, spec, coord, shape):
    """The chunk of ``full`` at mesh coordinate ``coord`` under ``spec``
    (per-dim parts over ``AXES``), the first of two axes the slower."""
    sizes = dict(zip(AXES, shape))
    at = dict(zip(AXES, coord))
    out = full
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, list) else [part]
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + at[a]
        step = full.shape[d] // n
        out = np.take(out, range(idx * step, (idx + 1) * step), axis=d)
    return out


def _ranks(ranks, name):
    return ranks[:math.prod(CASES[name][1])]


def _stages():
    return ["prefill"] + [f"decode{i}" for i in range(len(DECODE_POS))]


@pytest.mark.parametrize("name", list(CASES))
def test_cache_specs_match_reference(sides, name):
    """The port places each cache leaf as the reference's decode bundle
    does (``cache_axes()`` plus ``decode_cache_rules``), and the split on
    ``model`` is the one the case names."""
    ref, ranks = sides
    arch, shape, over, split = CASES[name]
    keys = sorted(k for k in ref if k.startswith(f"{name}/spec/"))
    assert keys
    for got in _ranks(ranks, name):
        assert sorted(k for k in got if k.startswith(f"{name}/spec/")) \
            == keys
        for k in keys:
            assert json.loads(str(got[k])) == json.loads(str(ref[k])), k
    attn = [json.loads(str(ref[k])) for k in keys if k.endswith(("/k",))]
    if split == "seq":
        assert all(sp[3] == "model" and sp[1] is None for sp in attn)
    elif split == "kv_heads":
        assert all(sp[1] == "model" for sp in attn)
    else:
        assert not attn


@pytest.mark.parametrize("against", ["reference", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_cache_chunks_match(sides, reach, name, against):
    """After the prefill and after each decode step, each rank's logits
    rows and each cache leaf's chunk equal the values at the rank's
    coordinate of the reference's jitted bundles, and of the port's
    mesh-free model; the chunk is the spec's share of the leaf.  Against
    the mesh-free model, which computes the same function with its sums
    in another order, each entry's bar also allows twice its spread, how
    far the mesh-free results move when their products sum in other
    orders (``tests/_torch_rounding.py``): jamba's split mamba mixers
    carried that order to 2.96e-5 in group 1's attention K on some CPUs'
    GEMMs, past TOL alone."""
    ref, ranks = sides
    shape = CASES[name][1]
    tol = (REF_TOL if against == "reference" else PLAIN_TOL).get(name, TOL)
    base = ref if against == "reference" else {
        k.replace("/plain/", "/", 1): v for k, v in ranks[0].items()
        if k.startswith(f"{name}/plain/")}
    moved = {f"{name}/{k}": v for k, v in reach(name).items()} \
        if against == "plain" else {}
    n = 0
    for got in _ranks(ranks, name):
        for stage in _stages():
            prefix = f"{name}/{stage}/"
            keys = [k for k in got if k.startswith(prefix)]
            assert len(keys) == len([k for k in base
                                     if k.startswith(prefix)])
            for k in keys:
                path, coord = k.split("@")
                coord = json.loads(coord)
                full = base[path]
                if path.endswith("/logits"):
                    spec = ["data" if shape[0] > 1 else None]
                else:
                    layer, leaf = path.split("/")[-3], path.split("/")[-1]
                    spec = json.loads(str(ref[f"{name}/spec/{layer}/"
                                              f"{leaf}"]))
                want = _chunk(full, spec, coord, shape)
                assert got[k].shape == want.shape, (k, got[k].shape)
                if against == "reference":
                    np.testing.assert_allclose(got[k], want, atol=tol,
                                               rtol=tol, err_msg=k)
                else:
                    assert_within(got[k], want, tol, tol, _chunk(
                        moved[path], spec, coord, shape), err_msg=k)
                n += 1
    assert n


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_free_model_matches_reference(sides, name):
    """The port's mesh-free ``Model.prefill`` and ``Model.decode_step``
    against the reference's jitted bundles, whole: the bar each case's
    mesh bundle is held to against the reference (``REF_TOL``: jamba's
    mesh-free model already differs from the reference by more than
    ``TOL``)."""
    ref, ranks = sides
    tol = REF_TOL.get(name, TOL)
    n = 0
    for stage in _stages():
        prefix = f"{name}/plain/{stage}/"
        keys = [k for k in ranks[0] if k.startswith(prefix)]
        assert len(keys) == len([k for k in ref if k.startswith(
            f"{name}/{stage}/")])
        for k in keys:
            want = ref[k.replace("/plain/", "/", 1)]
            assert ranks[0][k].shape == want.shape, k
            np.testing.assert_allclose(ranks[0][k], want, atol=tol,
                                       rtol=tol, err_msg=k)
            n += 1
    assert n


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[3] == "seq"])
def test_sequence_split_cache_is_never_whole_on_a_rank(sides, name):
    """Under ``cache_seq`` on ``model`` each rank's attention cache chunk
    holds S / m positions of every KV head, after every step."""
    _, ranks = sides
    m = CASES[name][1][AXES.index("model")]
    for got in _ranks(ranks, name):
        for stage in _stages():
            for k, v in got.items():
                if k.startswith(f"{name}/{stage}/") and "/mixer/" in k:
                    seq_dim = 3 if k.split("@")[0].endswith("/k") else 2
                    assert v.shape[seq_dim] * m == S, (k, v.shape)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith(("jamba", "xlstm"))])
def test_decode_reads_split_states_in_place(sides, name):
    """A decode step computes a split recurrent mixer (mamba, mLSTM,
    sLSTM) on its cache leaves' own local tensors and writes its new
    states into them: no leaf is gathered over the mesh and no collective
    reads a leaf's storage; where the plan leaves the mixers whole (2
    heads on 4 ranks) the leaves split over ``model`` are gathered, by a
    c10d all-gather that reads the leaf's storage (ROADMAP C18: no
    DTensor is redistributed), and computed on copies."""
    _, ranks = sides
    for got in _ranks(ranks, name):
        for i in range(len(DECODE_POS)):
            rep = json.loads(str(got[f"{name}/states{i}"]))
            assert rep["read_in_place"] and all(rep["kept"].values())
            assert rep["redistributions"] == 0, rep
            gathered = set(rep["redistributed"])
            if name in SPLIT_STATES:
                assert all(rep["read_in_place"].values()), rep
                assert not gathered and not rep["touched"], rep
            else:
                assert set(rep["touched"]) == gathered
                # the mLSTM's conv state: d_inner over "model", the mixer
                # whole
                assert gathered and all(k.endswith("/conv")
                                        for k in gathered)
                assert not any(rep["read_in_place"][k] for k in gathered)


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_bundles_equal_the_model(sides, name):
    """On a (1, 1) mesh the plan splits every kind present and the
    bundles equal ``Model.prefill`` and ``Model.decode_step``: logits and
    every cache leaf, bit for bit; and so does a decode step after a
    parameter is updated in place, and after one is replaced."""
    _, ranks = sides
    got = ranks[0]
    assert json.loads(str(got[f"one/{name}/kinds"])) == ONE_RANK[name]
    equal = json.loads(str(got[f"one/{name}/equal"]))
    assert len(equal) > 2 * len(DECODE_POS)
    assert [k for k, _ in equal[-2:]] == ["updated", "replaced"]
    assert [k for k, ok in equal if not ok] == []
