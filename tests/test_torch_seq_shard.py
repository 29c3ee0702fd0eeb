"""Sequence parallelism over ``model`` (``seq_shard``) in the port's mesh
step and prefill bundle, on the CPU.

Under ``seq_shard`` the reference puts ``act_seq`` on ``model``
(``repro/distributed/sharding.py``) and pins the residual stream to it at
every block boundary (``repro/models/transformer.py``), while the weights
split over ``model`` as usual: XLA runs Megatron's sequence parallelism.
The port's plan splits the same kinds as without it and marks the
sequence split (``TPPlan.seq``); where a call's sequence length divides
``model``, the residual stream holds each rank's S/m positions, every
sublayer gathers them and hands back the rank's positions of its output
(``distributed.sharding.sublayer_in`` / ``sublayer_out``).  What changes
is where values live, not what they are.

The harness is ``tests/test_torch_tp.py``'s: the reference in one
subprocess on 4 forced CPU devices (``jax.sharding.Mesh`` of ``Auto``
axes, ROADMAP C8), the port on 4 gloo ranks (``_torch_ranks``), smoke
configs, 2 steps at batch 8 x 32.  Cases:

- against the reference's mesh step under ``seq_shard``: qwen2-7b with 2
  KV heads on (1, 2) and gemma2-2b with ``fsdp_params`` and its window
  cut to 16 on (2, 2) ``("data", "model")``: the loss, each rank's
  chunks of the parameters and moments after each step, at the bars of
  ``tests/test_torch_tp.py``'s dense cases (``_hold_step``);
- against the port's own mesh step without ``seq_shard``, from the same
  state: jamba (mamba, attention, MLP and MoE layers), xlstm-125m (mLSTM
  and sLSTM) and granite-moe (its experts split by the plan, no
  ``ep_shard``) on (1, 2), at the bars those cases are held to against
  the mesh-free step (``test_torch_tp.py``'s ``_reach_parts``: the flat
  bars plus twice each entry's spread under reordered sums, ROADMAP C14);
- the prefill bundle: qwen2-7b with 2 KV heads on (1, 2) under
  ``seq_shard``, its logits and cache chunks against the reference's
  jitted prefill bundle, then 2 decode steps (which the sequence split
  leaves to plain tensor parallelism) at 2e-5;
- on each rank, the shapes that ``layer_apply`` sees: (B, S/m, D) in the
  train step and the prefill, (B, 1, D) in a decode step; a context
  splits the sequence only where the call's length divides ``model``;
- on a (1, 1) mesh, where every collective is an identity, the train
  step (qwen2-7b, gemma2-2b) and the prefill and decode bundles (qwen2-7b)
  under ``seq_shard`` equal the same runs without it bit for bit;
- the dry run at (2, 4): per-device FLOPs of the qwen2-7b, gemma2-2b,
  jamba, granite-moe and xlstm-125m smoke train and prefill cells under
  ``seq_shard`` equal the reference's, plus the computed terms that
  ``tests/test_torch_dryrun_moe.py`` allows.
"""
import json
import math
import os

import numpy as np
import pytest

import test_torch_dryrun_moe as dryrun_moe
from _torch_ranks import run_sides
from test_torch_distributed import _flat, _hold_step, _lr
from test_torch_tp import (  # noqa: F401  (reach: a fixture)
    _batches, _cfg, _init_state, _leaf_specs, _reach_parts, cut_reach, reach,
)

B, S, STEPS = 8, 32, 2
AXES = ("data", "model")
SEQ = dict(seq_shard=True)
# name: (arch, mesh shape, config changes, held against)
CASES = {
    "qwen2_12": ("qwen2-7b", (1, 2), dict(n_kv_heads=2, **SEQ),
                 "reference"),
    "gemma2_22": ("gemma2-2b", (2, 2),
                  dict(fsdp_params=True, sliding_window=16, **SEQ),
                  "reference"),
    "jamba_12": ("jamba-v0.1-52b", (1, 2), dict(SEQ), "plain"),
    "xlstm_12": ("xlstm-125m", (1, 2), dict(SEQ), "plain"),
    "moe_tp_12": ("granite-moe-3b-a800m", (1, 2), dict(SEQ), "plain"),
}
# the prefill bundle: (arch, mesh shape, config changes)
SERVE = ("qwen2-7b", (1, 2), dict(n_kv_heads=2, **SEQ))
SERVE_B = 4              # tests/test_torch_serve_bundles.py's batch
DECODE_POS = (20, 31)
SERVE_TOL = 2e-5         # tests/test_torch_serve_bundles.py's TOL
# on (1, 1), bit for bit against the same run without seq_shard
ONE_RANK = ("qwen2_12", "gemma2_22")
TIMEOUT = 420


def _axes(shape):
    return AXES if len(shape) == 2 else ("pod",) + AXES


def _without_seq(over):
    return {k: v for k, v in over.items() if k != "seq_shard"}


def _serve_cfg(over: dict, pkg: str):
    from test_torch_serve_bundles import _cfg as serve_cfg
    return serve_cfg(SERVE[0], over, pkg)


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
    from test_torch_serve_bundles import _tokens

    assert jax.device_count() == 4, jax.devices()
    res = {}

    def mesh_of(shape):
        return Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(
            shape), _axes(shape))

    for name, (arch, shape, over, against) in CASES.items():
        if against != "reference":
            continue
        cfg = _cfg(arch, over, "repro")
        m = mesh_of(shape)
        b = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"), m)
        step = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings)
        state = jax.device_put(
            jax.tree.map(np.asarray, b.init_fn(jax.random.key(0))),
            b.in_shardings[0])

        def shards(prefix, state):
            for key, arr in _flat(state).items():
                for s in arr.addressable_shards:
                    coord = tuple(int(i) for i in
                                  np.argwhere(m.devices == s.device)[0])
                    res[f"{prefix}/{key}@{coord}"] = np.asarray(s.data)

        shards(f"{name}/init", state)
        src = SyntheticLM(cfg.vocab_size, S, seed=0)
        for i in range(STEPS):
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in src.batch(i, 0, B).items()},
                b.in_shardings[1])
            with m:
                state, mt = step(state, batch)
            res[f"{name}/loss{i}"] = np.asarray(mt["loss"])
            shards(f"{name}/step{i}", state)

    # the prefill bundle and two decode steps
    arch, shape, over = SERVE
    cfg = _serve_cfg(over, "repro")
    m = mesh_of(shape)
    pb = make_step_bundle(cfg, ShapeCfg("p", S, SERVE_B, "prefill"), m)
    db = make_step_bundle(cfg, ShapeCfg("d", S, SERVE_B, "decode"), m)
    params = jax.device_put(pb.model.init_params(jax.random.key(0)),
                            pb.in_shardings[0])
    prefill = jax.jit(pb.step_fn, in_shardings=pb.in_shardings,
                      out_shardings=pb.out_shardings)
    decode = jax.jit(db.step_fn, in_shardings=db.in_shardings,
                     out_shardings=db.out_shardings)
    prompt, steps = _tokens(cfg)

    def save(stage, logits, cache):
        res[f"serve/{stage}/logits"] = np.asarray(logits)
        for layer, tree in cache.items():
            for n, leaf in tree["mixer"].items():
                full = np.asarray(leaf)
                for g in range(cfg.n_groups):
                    res[f"serve/{stage}/{g}/{layer}/mixer/{n}"] = full[g]

    with m:
        logits, cache = prefill(params, jnp.asarray(prompt))
    save("prefill", logits, cache)
    cache = jax.device_put(cache, db.in_shardings[1])
    for i, pos in enumerate(DECODE_POS):
        with m:
            logits, cache = decode(params, cache, jnp.asarray(steps[i]),
                                   jnp.int32(pos))
        save(f"decode{i}", logits, cache)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port, one gloo rank per process
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.sharding import (
        activation_sharding, current_seq,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.params import to_jax_state
    from repro_torch.train import make_step_bundle
    from repro_torch.train.steps import full_state, place_params
    from test_torch_serve_bundles import _port_params, _tokens

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}

    def init_state(bundle, arch, over):
        return _init_state(bundle, arch, _without_seq(over))

    batches = _batches

    def chunks(state, bundle):
        """This rank's local chunks in the reference's layout."""
        local = {"params": {k: p.to_local() for k, p in
                            state["params"].named_parameters()},
                 "opt": {part: {k: t.to_local() for k, t in
                                state["opt"][part].items()}
                         for part in ("m", "v")}}
        local["opt"]["step"] = state["opt"]["step"].to_local()
        coord = tuple(bundle.mesh.get_coordinate())
        return {f"{key}@{coord}": t.numpy().copy() for key, t in
                _flat(to_jax_state(bundle.cfg, local)).items()}

    class record_shapes:
        """The shapes of the residual stream that ``layer_apply`` sees,
        by mode."""

        def __enter__(self):
            self.saved, self.seen = transformer.layer_apply, {}

            def layer_apply(p, x, *a, mode, **k):
                self.seen.setdefault(mode, set()).add(tuple(x.shape))
                return self.saved(p, x, *a, mode=mode, **k)

            transformer.layer_apply = layer_apply
            return self

        def __exit__(self, *exc):
            transformer.layer_apply = self.saved

        def report(self):
            return {k: sorted(v) for k, v in self.seen.items()}

    def run_steps(bundle, state, get):
        out = {}
        for i in range(STEPS):
            state, mt = bundle.step_fn(state, get(i))
            out[f"loss{i}"] = mt["loss"].numpy().copy()
            out[f"step_count{i}"] = mt["step"].numpy().copy()
            out.update({f"step{i}/{k}": v for k, v in
                        chunks(state, bundle).items()})
        return out

    shape_cfg = ShapeCfg("t", S, B, "train")
    for name, (arch, shape, over, against) in CASES.items():
        cfg = _cfg(arch, over, "repro_torch")
        mesh = make_mesh(shape, _axes(shape), "cpu")
        bundle = make_step_bundle(cfg, shape_cfg, mesh)
        if mesh.get_coordinate() is None:
            continue
        res[f"{name}/kinds"] = np.array(json.dumps(sorted(bundle.tp.kinds)))
        res[f"{name}/seq"] = np.array(bundle.tp.seq)
        get = batches(cfg)
        state = init_state(bundle, arch, over)
        for k, v in chunks(state, bundle).items():
            res[f"{name}/init/{k}"] = v
        with record_shapes() as rec:
            for k, v in run_steps(bundle, state, get).items():
                res[f"{name}/{k}"] = v
        res[f"{name}/shapes"] = np.array(json.dumps(rec.report()))
        if against == "plain":
            # the port's mesh step without seq_shard, from the same state
            plain_cfg = _cfg(arch, _without_seq(over), "repro_torch")
            plain = make_step_bundle(plain_cfg, shape_cfg, mesh)
            res[f"{name}/plain_kinds"] = np.array(json.dumps(sorted(
                plain.tp.kinds)))
            for k, v in run_steps(plain, init_state(plain, arch, over),
                                  get).items():
                res[f"{name}/plain/{k}"] = v
            res[f"{name}/specs"] = np.array(json.dumps(_leaf_specs(bundle)))

    # --- the sequence split only where the call's length divides model ----
    m12 = make_mesh((1, 2), AXES, "cpu")
    if m12.get_coordinate() is not None:
        arch, shape, over, _ = CASES["qwen2_12"]
        plan = make_step_bundle(_cfg(arch, over, "repro_torch"), shape_cfg,
                                m12).tp
        split = {}
        for n in (1, 31, 32):
            with activation_sharding(m12, _cfg(arch, over, "repro_torch"),
                                     tp=plan, seq_len=n):
                split[n] = current_seq() is not None
        res["split_at"] = np.array(json.dumps(split))

    # --- the prefill bundle and two decode steps -----------------------------
    arch, shape, over = SERVE
    cfg = _serve_cfg(over, "repro_torch")
    mesh = make_mesh(shape, AXES, "cpu")
    pb = make_step_bundle(cfg, ShapeCfg("p", S, SERVE_B, "prefill"), mesh)
    db = make_step_bundle(cfg, ShapeCfg("d", S, SERVE_B, "decode"), mesh)
    if mesh.get_coordinate() is not None:
        coord = json.dumps(list(mesh.get_coordinate()))
        params = place_params(cfg, _port_params(cfg, arch, over),
                              pb.in_shardings[0])
        prompt, steps = _tokens(cfg)

        def save(stage, logits, cache):
            res[f"serve/{stage}/logits@{coord}"] = logits.to_local().numpy()
            for g, gc in enumerate(cache):
                for layer, tree in gc.items():
                    for n, leaf in tree["mixer"].items():
                        res[f"serve/{stage}/{g}/{layer}/mixer/{n}@{coord}"] \
                            = leaf.to_local().numpy().copy()

        with record_shapes() as rec:
            logits, cache = pb.step_fn(params,
                                       torch.from_numpy(prompt).long())
            save("prefill", logits, cache)
            for i, pos in enumerate(DECODE_POS):
                logits, cache = db.step_fn(
                    params, cache, torch.from_numpy(steps[i]).long(), pos)
                save(f"decode{i}", logits, cache)
        res["serve/shapes"] = np.array(json.dumps(rec.report()))
        res["serve/specs"] = np.array(json.dumps({
            f"{layer}/{n}": list(sh.spec) for layer, tree in
            db.in_shardings[1][0].items()
            for n, sh in tree["mixer"].items()}, default=list))

    # --- one rank: seq_shard against the same runs without it ---------------
    m11 = make_mesh((1, 1), AXES, "cpu")
    if m11.get_coordinate() is not None:
        for name in ONE_RANK:
            arch, _, over, _ = CASES[name]
            runs = []
            for o in (over, _without_seq(over)):
                cfg = _cfg(arch, o, "repro_torch")
                b = make_step_bundle(cfg, shape_cfg, m11)
                runs.append((b, init_state(b, arch, over)))
            get = batches(runs[0][0].cfg)
            equal = []
            for i in range(STEPS):
                (a, ma), (b, mb) = [bd.step_fn(st, get(i))
                                    for bd, st in runs]
                equal.append(("loss", bool(torch.equal(ma["loss"],
                                                       mb["loss"]))))
                fa, fb = _flat(full_state(a)), _flat(full_state(b))
                equal += [(k, bool(torch.equal(fa[k], fb[k]))) for k in fb]
            res[f"one/{name}/equal"] = np.array(json.dumps(equal))
        arch, _, over = SERVE
        outs = []
        for o in (over, _without_seq(over)):
            cfg = _serve_cfg(o, "repro_torch")
            pb = make_step_bundle(cfg, ShapeCfg("p", S, SERVE_B, "prefill"),
                                  m11)
            db = make_step_bundle(cfg, ShapeCfg("d", S, SERVE_B, "decode"),
                                  m11)
            params = place_params(cfg, _port_params(cfg, arch, over),
                                  pb.in_shardings[0])
            prompt, steps = _tokens(cfg)
            logits, cache = pb.step_fn(params,
                                       torch.from_numpy(prompt).long())
            got = [logits.to_local()] + [
                t.to_local().clone() for gc in cache for tree in gc.values()
                for t in tree["mixer"].values()]
            for i, pos in enumerate(DECODE_POS):
                logits, cache = db.step_fn(
                    params, cache, torch.from_numpy(steps[i]).long(), pos)
                got.append(logits.to_local())
            got += [t.to_local() for gc in cache for tree in gc.values()
                    for t in tree["mixer"].values()]
            outs.append(got)
        res["one/serve/equal"] = np.array(json.dumps(
            [bool(torch.equal(a, b)) for a, b in zip(*outs)]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return run_sides(tmp_path_factory.mktemp("seq"), "test_torch_seq_shard",
                     4, 4, TIMEOUT)


def _in_mesh(ranks, name):
    return ranks[:math.prod(CASES[name][1])]


@pytest.mark.parametrize("name", list(CASES))
def test_plan_splits_the_kinds_it_splits_without_seq_shard(sides, name):
    """The plan splits the kinds of ``tests/test_torch_tp.py``'s case of
    the same arch, mesh and changes, and marks the sequence split."""
    from test_torch_tp import CASES as TP_CASES
    _, ranks = sides
    arch, shape, over, _ = CASES[name]
    want = next(kinds for a, sh, o, kinds in TP_CASES.values()
                if (a, sh, o) == (arch, shape, _without_seq(over)))
    for got in _in_mesh(ranks, name):
        assert json.loads(str(got[f"{name}/kinds"])) == sorted(want)
        assert bool(got[f"{name}/seq"])
        if f"{name}/plain_kinds" in got:
            assert json.loads(str(got[f"{name}/plain_kinds"])) == \
                sorted(want)


@pytest.mark.parametrize("name", list(CASES))
def test_residual_stream_holds_the_ranks_positions(sides, name):
    """In the train step every layer's input is the rank's rows and S/m
    positions."""
    _, ranks = sides
    _, shape, _, _ = CASES[name]
    rows = B // math.prod(shape[:-1])
    for got in _in_mesh(ranks, name):
        seen = json.loads(str(got[f"{name}/shapes"]))
        assert seen == {"train": [[rows, S // shape[-1], 128]]}, seen


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match(sides, name):
    ref, ranks = sides
    against = CASES[name][3]
    for got in _in_mesh(ranks, name):
        base = ref if against == "reference" else {
            k.replace("/plain/", "/", 1): v for k, v in got.items()
            if k.startswith(f"{name}/plain/")}
        for i in range(STEPS):
            np.testing.assert_allclose(got[f"{name}/loss{i}"],
                                       base[f"{name}/loss{i}"], rtol=1e-5)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[3] == "reference"])
def test_chunks_match_reference_shards(sides, name):
    """Each rank's chunks after each step against the reference's
    ``seq_shard`` step's shards at its coordinate (the initial state is
    the reference's, placed as the reference places it, exactly)."""
    ref, ranks = sides
    got_ranks = _in_mesh(ranks, name)
    for got in got_ranks:
        keys = [k for k in got if k.startswith(f"{name}/init/")]
        assert keys and all(k in ref for k in keys)
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(ref, got_ranks, name, i, prev, _lr(i + 1))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[3] == "plain"])
def test_chunks_match_the_step_without_seq_shard(sides, reach, name):
    """Each rank's chunks after each step against the port's mesh step
    without ``seq_shard`` from the same state, at the bars of
    ``tests/test_torch_tp.py``'s recurrent cases against the mesh-free
    step (the moments at the flat bars plus twice each entry's spread,
    ROADMAP C14)."""
    _, ranks = sides
    got_ranks = _in_mesh(ranks, name)
    plain = {k.replace("/plain/", "/", 1): v for got in got_ranks
             for k, v in got.items() if k.startswith(f"{name}/plain/")}
    arch, shape, over, _ = CASES[name]
    moved = cut_reach(reach(arch, _without_seq(over)), name, got_ranks,
                      shape)
    plain.update({k: v for got in got_ranks for k, v in got.items()
                  if k.startswith(f"{name}/init/")})
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(plain, got_ranks, name, i, prev, _lr(i + 1),
                   state_parts=_reach_parts(moved), reach=moved)


def test_split_only_where_the_length_divides_model(sides):
    _, ranks = sides
    for got in ranks[:2]:
        assert json.loads(str(got["split_at"])) == {
            "1": False, "31": False, "32": True}


def test_prefill_and_decode_match_reference(sides):
    """The ``seq_shard`` prefill bundle's logits and cache chunks, and two
    decode steps after it, against the reference's jitted bundles at the
    rank's coordinate (float32 atol = rtol = 2e-5); each layer sees the
    rank's S/m positions in the prefill and one position a decode step."""
    from test_torch_serve_bundles import _chunk
    ref, ranks = sides
    shape = SERVE[1]
    n = 0
    for got in ranks[:math.prod(shape)]:
        seen = json.loads(str(got["serve/shapes"]))
        assert seen == {"prefill": [[SERVE_B, S // shape[-1], 128]],
                        "decode": [[SERVE_B, 1, 128]]}, seen
        specs = json.loads(str(got["serve/specs"]))
        for k in (k for k in got if k.startswith("serve/")
                  and "@" in k):
            path, coord = k.split("@")
            if path.endswith("/logits"):
                spec = []
            else:
                layer, leaf = path.split("/")[-3], path.split("/")[-1]
                spec = specs[f"{layer}/{leaf}"]
            want = _chunk(ref[path], spec, json.loads(coord), shape)
            assert got[k].shape == want.shape, (k, got[k].shape)
            np.testing.assert_allclose(got[k], want, atol=SERVE_TOL,
                                       rtol=SERVE_TOL, err_msg=k)
            n += 1
    assert n > 3


@pytest.mark.parametrize("name", list(ONE_RANK) + ["serve"])
def test_one_rank_equals_the_run_without_seq_shard(sides, name):
    """On a (1, 1) mesh the sequence split's collectives are identities:
    two train steps (the loss, every parameter and moment), or a prefill
    and two decode steps (the logits and every cache leaf), equal the
    same runs without ``seq_shard`` bit for bit."""
    _, ranks = sides
    equal = json.loads(str(ranks[0][f"one/{name}/equal"]))
    assert len(equal) > 3
    if name == "serve":
        assert all(equal), equal
    else:
        assert [k for k, ok in equal if not ok] == [], equal


# ---------------------------------------------------------------------------
# The dry run at (2, 4), both sides under seq_shard
# ---------------------------------------------------------------------------

DRY = [(a, k) for a in ("qwen2-7b", "gemma2-2b", "jamba-v0.1-52b",
                        "granite-moe-3b-a800m", "xlstm-125m")
       for k in ("train", "prefill")]


def _dry_run(code, out_dir, **kw):
    saved = dryrun_moe.CELLS
    dryrun_moe.CELLS = DRY
    try:
        return dryrun_moe._run(code.replace(
            "overrides=smoke(a)", "overrides=dict(smoke(a), seq_shard=True)"),
            out_dir, 900, **kw)
    finally:
        dryrun_moe.CELLS = saved


@pytest.fixture(scope="module")
def dry_ref(tmp_path_factory):
    return _dry_run(dryrun_moe.REF, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def dry_port(tmp_path_factory):
    return _dry_run(dryrun_moe.PORT, tmp_path_factory.mktemp("port"),
                    jax_platform=False)


def seq_terms(arch: str, kind: str) -> int:
    """``tests/test_torch_dryrun_moe.py``'s terms of a cell, less the
    recompute of the loss chunk's logits product, which the reference's
    compiled step under ``seq_shard`` runs too: its HLO holds one more
    (B / data x S, d_model) x (d_model, vocab / model) dot than without
    ``seq_shard`` (three against two; every other dot it rearranges over
    the split positions sums to the same FLOPs)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    if kind != "train":
        return 0
    cfg = reduce_for_smoke(get_config(arch))
    rows = dryrun_moe.B // dryrun_moe.DATA
    logits = (2 * rows * dryrun_moe.S * cfg.d_model
              * (cfg.vocab_size // dryrun_moe.MODEL))
    return dryrun_moe.terms(arch, kind) - logits


@pytest.mark.parametrize("arch,kind", DRY)
def test_dry_run_flops_per_device_match_the_reference(dry_ref, dry_port,
                                                      arch, kind):
    """The port's per-device FLOPs under ``seq_shard`` equal the
    reference's plus :func:`seq_terms`: the same products, each rank's
    share of every split sublayer over the whole sequence and the sLSTM's
    whole down projection on the rank's positions, as the reference's
    partitioner runs them."""
    want, got = dry_ref[f"{arch}:{kind}"], dry_port["cells"][f"{arch}:{kind}"]
    assert want["status"] == got["status"] == "OK", (want, got)
    ref_flops = want["hlo_analysis"]["flops_per_device"]
    port_flops = got["hlo_analysis"]["flops_per_device"]
    extra = seq_terms(arch, kind)
    assert ref_flops > 0
    assert port_flops == ref_flops + extra, (port_flops, ref_flops, extra,
                                             port_flops - ref_flops)
    assert got["model_flops_total"] == want["model_flops_total"]
