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
  and tensor-parallel attention on one ``model`` axis;
- xlstm-125m (mLSTM and sLSTM layers, d_inner 256, 4 heads) on (1, 2)
  and (1, 4): the mLSTM by heads, the sLSTM by heads, its post-FFN
  (width 170) column- and row-parallel at m=2 and whole at m=4;
- jamba-v0.1-52b (mamba, attention, MLP and MoE layers) on (1, 2), and
  with ``fsdp_params`` on (2, 2): the mamba mixer by ``d_inner``
  channels (its ``embed`` dim on ``data`` as well under fsdp);
- xlstm-125m with int8 compression on (2, 1, 2) ``("pod", "data",
  "model")``, one microbatch (ROADMAP C9), as
  ``tests/test_torch_distributed.py`` builds it: the gate leaves'
  gradients pass the gather over ``model`` before the quantizer;
  granite-moe-3b-a800m likewise, its experts split over ``model``;
- granite-moe-3b-a800m without ``ep_shard`` on (1, 2) and (2, 2) (4
  experts split by the plan, two a rank, at the capacity of the routed
  batch, split over ``data`` on (2, 2)), and with 3 experts on (1, 2)
  (their ``d_ff`` split instead); llama4-maverick-400b-a17b on (1, 2)
  (4 experts top-1, the shared expert by its ``d_ff``, MoE and dense
  layers); jamba's MoE layers split by their experts too.  Each MoE
  call's routing decisions in the first step equal the mesh-free
  step's.

What is checked: both steps' losses (rtol 1e-5); each rank's chunks of
the parameters and moments against the reference's shards at its
coordinate, at ``tests/test_torch_distributed.py``'s tolerances (its
module doc; the xLSTM cases' moments at the per-entry bar of
``tests/test_torch_optim.py``, ROADMAP C16), and the recurrent cases'
against the port's mesh-free step at those tolerances; under int8, the
gradients the quantizer gets against the mesh-free gradient of the
pod's rows (ROADMAP C16); where a comparison is of two float32 orders of
one function (a split against the whole, the mesh against the mesh-free
step), the bar also allows twice each entry's spread, how far the
mesh-free side moves when its products sum in other orders
(``tests/_torch_rounding.py``; for the whole models computed in the
test's process once the ranks are done, off their deadline); that the
plan splits what the config allows, that each tensor-parallel leaf's
compute view holds 1/m of its elements with ``Shard`` on ``model``
(never gathered whole over ``model``), or
for a gate leaf (mamba's ``in_proj``, the mLSTM's ``up_proj``, the
sLSTM's ``w`` and ``b``) the rank's chunk of each gate block of the
whole leaf, its gradient back in the leaf's storage chunk (the one the
step's AdamW updates); each split recurrent mixer against its whole
layer (output, gradients, states, a decode step) at 2e-5 plus that
spread; the
vocab-parallel cross-entropy on 2 ranks against ``torch.logsumexp``; and
that on a (1, 1) mesh, where the same code runs with its collectives as
identities, the step equals the mesh-free step bit for bit.  In this
process: the plan's decisions for the full configs, and the KV heads
that a rank's query heads read where the KV heads do not split,
including groupings that no smoke config reaches.
"""
import copy
import json
import math
import os

import numpy as np
import pytest

from _torch_ranks import run_sides
from _torch_rounding import assert_within, spread, within
from test_torch_distributed import _flat, _hold_step, _lr

B, S, STEPS = 8, 32, 2
ALL = {"heads", "kv_heads", "ffn", "vocab"}
XLSTM = {"mlstm", "slstm", "slstm_ffn", "vocab"}
JAMBA = {"heads", "kv_heads", "ffn", "mamba", "vocab", "expert"}
GRANITE = {"heads", "kv_heads", "vocab", "expert"}
LLAMA4 = ALL | {"expert", "shared"}
# name: (arch, mesh shape, config changes, kinds the plan splits)
CASES = {
    "qwen2_12": ("qwen2-7b", (1, 2), dict(n_kv_heads=2), ALL),
    "qwen2_14": ("qwen2-7b", (1, 4), dict(n_kv_heads=2),
                 {"heads", "ffn", "vocab"}),
    "gemma2_22": ("gemma2-2b", (2, 2),
                  dict(fsdp_params=True, sliding_window=16), ALL),
    "granite34_12": ("granite-34b", (1, 2), {}, {"heads", "ffn", "vocab"}),
    "moe_22": ("granite-moe-3b-a800m", (2, 2), dict(ep_shard=True),
               GRANITE),
    # without expert parallelism: the experts split by the plan, each rank
    # its experts at the capacity of the routed (gathered) batch
    "moe_tp_12": ("granite-moe-3b-a800m", (1, 2), {}, GRANITE),
    "moe_tp_22": ("granite-moe-3b-a800m", (2, 2), {}, GRANITE),
    # 3 experts on 2 ranks: the experts' d_ff splits instead
    "moe_ffn_12": ("granite-moe-3b-a800m", (1, 2), dict(num_experts=3),
                   GRANITE - {"expert"} | {"expert_ffn"}),
    # 4 experts top-1 and the shared expert, MoE and dense layers; float32
    # moments (the config's are bf16, which numpy cannot hold)
    "llama4_12": ("llama4-maverick-400b-a17b", (1, 2),
                  dict(opt_dtype="float32"), LLAMA4),
    # the sLSTM's post-FFN (170 wide) splits at m=2, not at m=4
    "xlstm_12": ("xlstm-125m", (1, 2), {}, XLSTM),
    "xlstm_14": ("xlstm-125m", (1, 4), {}, XLSTM - {"slstm_ffn"}),
    "jamba_12": ("jamba-v0.1-52b", (1, 2), {}, JAMBA),
    "jamba_22": ("jamba-v0.1-52b", (2, 2), dict(fsdp_params=True), JAMBA),
    "xlstm_int8": ("xlstm-125m", (2, 1, 2), dict(grad_compression="int8"),
                   XLSTM),
    # the experts split over model under int8: their gradients gathered
    # whole before the quantizer, as the other kinds' (no expert
    # parallelism, whose route the reference cannot run with int8: C13)
    "moe_int8": ("granite-moe-3b-a800m", (2, 1, 2),
                 dict(grad_compression="int8"), GRANITE),
}
AXES = ("data", "model")
AXES3 = ("pod", "data", "model")
# the recurrent mixers' cases: also held against the port's mesh-free step
PLAIN = ("xlstm_12", "xlstm_14", "jamba_12", "jamba_22")
# int8 compression: the quantizer's input held against the mesh-free
# gradient of the pod's rows (ROADMAP C16)
QUANTIZED = ("xlstm_int8", "moe_int8")
# on a (1, 1) mesh, bit for bit: {name: the kinds split there}
ONE_RANK = {"qwen2_12": ALL, "gemma2_22": ALL, "xlstm_12": XLSTM,
            "jamba_12": JAMBA, "moe_tp_12": GRANITE, "llama4_12": LLAMA4}
# the MoE cases: each MoE call's routing decisions (expert ids, slots,
# keep) in the first step, against the mesh-free step's, exactly
ROUTED = ("moe_tp_12", "moe_tp_22", "moe_ffn_12", "llama4_12", "jamba_12")
# the leaves of each kind: by the ends of their keys for the dense
# layers, by the recurrent mixer and the leaf's name for the others
KIND_LEAVES = {"heads": (".mixer.wq", ".mixer.bq", ".mixer.wo"),
               "kv_heads": (".mixer.wk", ".mixer.wv", ".mixer.bk",
                            ".mixer.bv"),
               "ffn": (".ffn.w_up", ".ffn.w_gate", ".ffn.w_down"),
               "vocab": ("embed.embedding", "embed.unembed")}
# an MoE layer's leaves: the router by its experts, the expert leaves by
# their experts or by their d_ff, the shared expert by its d_ff
MOE_LEAVES = {"router": ("expert",), "w_up": ("expert", "expert_ffn"),
              "w_gate": ("expert", "expert_ffn"),
              "w_down": ("expert", "expert_ffn"),
              "shared_up": ("shared",), "shared_gate": ("shared",),
              "shared_down": ("shared",)}
MIXER_LEAVES = {
    "mamba": {n: "mamba" for n in ("in_proj", "conv_w", "conv_b", "x_proj",
                                   "dt_proj", "dt_bias", "A_log", "D",
                                   "out_proj")},
    "mlstm": {n: "mlstm" for n in ("up_proj", "conv_w", "conv_b", "wq", "wk",
                                   "wv", "w_if", "b_i", "b_f", "skip",
                                   "norm_scale", "down_proj")},
    "slstm": {"w": "slstm", "r": "slstm", "b": "slstm",
              "ffn_up": "slstm_ffn", "ffn_down": "slstm_ffn"},
}
# leaves whose split dim is gate blocks side by side: (mixer, name): blocks
GATES = {("mamba", "in_proj"): 2, ("mlstm", "up_proj"): 2,
         ("slstm", "w"): 4, ("slstm", "b"): 4}
CE_SHAPE, CE_VOCAB = (4, 8), 64
# the layer test: (arch, layer, mixer) of group 0, on (1, 2) and (1, 4)
MIXERS = (("jamba-v0.1-52b", "l0", "mamba"), ("xlstm-125m", "l0", "mlstm"),
          ("xlstm-125m", "l3", "slstm"))
MIXER_MESHES = ((1, 2), (1, 4))
LAYER_TOL = 2e-5        # single functions: tests/test_torch_models.py
# the subprocesses' deadline: the reference side's 16 cases took up to
# 420 s under the whole suite's load (6 workers on 8 cores)
TIMEOUT = 720


MOE_KEYS = ("ep_shard", "num_experts")     # changes of cfg.moe


def _axes(shape):
    return AXES if len(shape) == 2 else AXES3


def _leaf_kind(cfg, key: str, kinds=()):
    """The kind whose plan splits ``key`` (None: a leaf no kind splits);
    an expert leaf's "expert_ffn" where ``kinds`` has it."""
    parts = key.split(".")
    if parts[0] != "groups":
        return "vocab" if key in KIND_LEAVES["vocab"] else None
    layer = cfg.pattern[int(parts[2][1:])]
    if parts[3] == "mixer" and layer.mixer in MIXER_LEAVES:
        return MIXER_LEAVES[layer.mixer].get(parts[4])
    if parts[3] == "ffn" and layer.ffn == "moe":
        options = MOE_LEAVES[parts[4]]
        return options[-1] if options[-1] in kinds else options[0]
    return next((kind for kind, ends in KIND_LEAVES.items()
                 if any(key.endswith(e) for e in ends)), None)


def _gate_blocks(cfg, key: str):
    parts = key.split(".")
    if parts[0] != "groups" or parts[3] != "mixer":
        return None
    return GATES.get((cfg.pattern[int(parts[2][1:])].mixer, parts[4]))


def _cfg(arch: str, over: dict, pkg: str):
    import dataclasses
    mod = __import__(f"{pkg}.configs", fromlist=["get_config"])
    cfg = mod.reduce_for_smoke(mod.get_config(arch))
    moe = {k: v for k, v in over.items() if k in MOE_KEYS}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(
        cfg, **{k: v for k, v in over.items() if k not in MOE_KEYS})


def _ce_inputs():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, CE_SHAPE + (CE_VOCAB,)).astype(np.float32)
    labels = rng.integers(0, CE_VOCAB, CE_SHAPE)
    return logits, labels


def _init_state(bundle, arch, over):
    """``bundle``'s state holding the reference's initial state
    (``init_fn(key(0))``)."""
    import jax
    import torch
    from repro.configs.base import ShapeCfg as JShape
    from repro.train import make_step_bundle as jbundle
    from repro_torch.models.params import from_jax_state
    from repro_torch.train import load_state
    jcfg = _cfg(arch, over, "repro")
    jstate = jbundle(jcfg, JShape("t", S, B, "train")).init_fn(
        jax.random.key(0))
    state = bundle.init_fn(torch.Generator().manual_seed(0))
    tree = from_jax_state(bundle.cfg, jax.tree.map(np.asarray, jstate))
    if "ef" in state:       # the reference makes it on a mesh only
        tree["ef"] = {k: torch.zeros(v.shape)
                      for k, v in tree["params"].items()}
    load_state(state, tree)
    return state


def _batches(cfg):
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(cfg.vocab_size, S, seed=0)
    return lambda i: {k: torch.from_numpy(v) for k, v in
                      src.batch(i, 0, B).items()}


def _leaf_specs(bundle) -> dict:
    """{state key (the reference's layout): its spec, JSON-ready}."""
    from repro_torch.models.params import to_jax_state
    return {k: [list(p) if isinstance(p, tuple) else p for p in sh.spec]
            for k, sh in _flat(to_jax_state(bundle.cfg,
                                            bundle.in_shardings[0])).items()}


def _cut(full, spec, coord, shape):
    """The chunk of ``full`` at mesh coordinate ``coord`` of a mesh of
    ``shape`` under ``spec`` (per-dim parts: None, an axis or a list of
    axes, the first the slower), as ``local_chunk`` cuts it."""
    sizes = dict(zip(_axes(shape), shape))
    at = dict(zip(_axes(shape), coord))
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


def mesh_free_reach(arch, over):
    """How far the mesh-free steps' state moves when their products sum
    in other orders (``_torch_rounding.spread``), whole, in the
    reference's layout: {"step<i>/<key>": spread}.  Computed in the test's
    process once the ranks are done, off their deadline."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.params import to_jax_state
    from repro_torch.train import make_step_bundle
    cfg = _cfg(arch, over, "repro_torch")
    free = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
    get = _batches(cfg)
    start = _init_state(free, arch, over)

    def steps():
        state, out = copy.deepcopy(start), {}
        for i in range(STEPS):
            state, _ = free.step_fn(state, get(i))
            out.update({f"step{i}/{k}": t.detach().numpy().copy()
                        for k, t in _flat(to_jax_state(cfg, state)).items()})
        return out

    return spread(steps)


def _pod_grad(cfg, params, pod, pods):
    """The mesh-free gradient of pod ``pod``'s rows of the first batch
    (one microbatch, one rank on "data") at ``params``, in the
    reference's layout."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.params import to_jax_params
    model = Model(cfg, device="cpu")
    model.load_state_dict(params)
    model.requires_grad_(True)
    rows = slice(pod * B // pods, (pod + 1) * B // pods)
    loss, _ = model.loss({k: t[rows] for k, t in _batches(cfg)(0).items()})
    g = torch.autograd.grad(loss, list(model.parameters()))
    return {k: t.numpy() for k, t in _flat(to_jax_params(
        cfg, dict(zip(dict(model.named_parameters()), g)))).items()}


def pod_grad_reach(arch, over, pod, pods):
    """How far :func:`_pod_grad` at the initial parameters moves when its
    products sum in other orders, computed in the test's process."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.train import make_step_bundle
    cfg = _cfg(arch, over, "repro_torch")
    state = _init_state(make_step_bundle(cfg, ShapeCfg("t", S, B, "train")),
                        arch, over)
    params = {k: p.detach() for k, p in
              state["params"].named_parameters()}
    return spread(lambda: _pod_grad(cfg, params, pod, pods))


def cut_reach(reach, name, got_ranks, shape):
    """``reach`` (whole, from :func:`mesh_free_reach`) cut at each rank's
    coordinate, keyed as the ranks' chunks ("<name>/step<i>/<key>@<coord>").
    """
    import ast
    out = {}
    for got in got_ranks:
        specs = json.loads(str(got[f"{name}/specs"]))
        coord = next(k for k in got if k.startswith(f"{name}/init/")
                     ).split("@")[1]
        at = ast.literal_eval(coord)
        for k, v in reach.items():
            step, key = k.split("/", 1)
            out[f"{name}/{step}/{key}@{coord}"] = _cut(v, specs[key], at,
                                                      shape)
    return out


@pytest.fixture(scope="module")
def reach():
    """Per (arch, config changes): :func:`mesh_free_reach`, computed once,
    in this process."""
    cache = {}

    def get(arch, over):
        # the mesh-free step does not read fsdp_params
        over = {k: v for k, v in over.items() if k != "fsdp_params"}
        key = (arch, json.dumps(over, sort_keys=True))
        if key not in cache:
            cache[key] = mesh_free_reach(arch, over)
        return cache[key]

    return get


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
                 _axes(shape))
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
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.collectives import vocab_parallel_ce
    from repro_torch.distributed.sharding import local_chunk, view_as
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.params import to_jax_state
    from repro_torch.train import make_step_bundle
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.steps import full_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}

    init_state, batches = _init_state, _batches

    def chunks(prefix, state, bundle):
        """This rank's local chunks in the reference's layout."""
        local = {"params": {k: p.to_local() for k, p in
                            state["params"].named_parameters()},
                 "opt": {part: {k: t.to_local() for k, t in
                                state["opt"][part].items()}
                         for part in ("m", "v")}}
        local["opt"]["step"] = state["opt"]["step"].to_local()
        if "ef" in state:
            local["ef"] = {k: t.to_local() for k, t in state["ef"].items()}
        coord = tuple(bundle.mesh.get_coordinate())
        for key, t in _flat(to_jax_state(bundle.cfg, local)).items():
            res[f"{prefix}/{key}@{coord}"] = t.numpy()

    class record_views:
        """Each leaf's compute view in a step: (its elements, the leaf's
        elements, the placements asked for, whether it is a gate view);
        for the gate leaves also the view and the leaf's whole value, and
        the gradient chunks the step makes of their views (in the plan's
        order of ``gates``)."""

        def __init__(self, state, keep: bool):
            self.keys = {id(p): k for k, p in
                         state["params"].named_parameters()}
            self.keep = keep        # the gate views' values too
            self.seen, self.gate_views, self.grad_chunks = {}, {}, []

        def __enter__(self):
            self.saved = (steps_mod.compute_view, steps_mod.gate_chunk)

            def compute_view(t, placements=None, gates=None):
                out = self.saved[0](t, placements, gates)
                if id(t) in self.keys:
                    key = self.keys[id(t)]
                    self.seen[key] = (
                        out.numel(), t.numel(),
                        [repr(p) for p in placements or ()],
                        gates is not None)
                    if gates is not None and self.keep:
                        self.gate_views[key] = (out.numpy().copy(),
                                                view_as(t).numpy().copy())
                return out

            def gate_chunk(view, *a):
                out = self.saved[1](view, *a)
                self.grad_chunks.append(out.detach().numpy().copy())
                return out

            steps_mod.compute_view, steps_mod.gate_chunk = (compute_view,
                                                            gate_chunk)
            return self

        def __exit__(self, *exc):
            steps_mod.compute_view, steps_mod.gate_chunk = self.saved

    def cut_chunks(state, bundle):
        """The mesh-free step's state cut as ``bundle``'s state is placed,
        at this rank's coordinate (the reference's layout)."""
        full = _flat(to_jax_state(bundle.cfg, state))
        placed = _flat(to_jax_state(bundle.cfg, bundle.in_shardings[0]))
        coord = tuple(bundle.mesh.get_coordinate())
        return {f"{key}@{coord}": local_chunk(
            t, bundle.mesh, placed[key].placements).numpy().copy()
            for key, t in full.items()}

    def plain_chunks(prefix, state, bundle):
        for key, t in cut_chunks(state, bundle).items():
            res[f"{prefix}/{key}"] = t


    class record_quantizer:
        """The gradient tree the compressed step hands the quantizer
        (the reference's layout, gathered over ``model``)."""

        def __enter__(self):
            self.saved = steps_mod.compressed_pod_allreduce
            self.trees = []

            def quantize(grads, *a):
                self.trees.append({k: t.detach().numpy().copy()
                                   for k, t in _flat(grads).items()})
                return self.saved(grads, *a)

            steps_mod.compressed_pod_allreduce = quantize
            return self

        def __exit__(self, *exc):
            steps_mod.compressed_pod_allreduce = self.saved

    class record_routes:
        """Each MoE call's routing decisions: (expert ids, slots, keep)."""

        def __enter__(self):
            from repro_torch.models import moe
            self.saved, self.calls = moe.route, []

            def route(*a, **k):
                out = self.saved(*a, **k)
                self.calls.append([t.detach().numpy().copy()
                                   for t in out[2:]])
                return out

            moe.route = route
            return self

        def __exit__(self, *exc):
            from repro_torch.models import moe
            moe.route = self.saved

    def mixer_layers(mesh, m):
        """Each recurrent mixer of MIXERS on this rank's views of a whole
        layer (the plan's chunks and gate views), inside the plan's
        context, beside the whole layer outside it: the output, its
        gradient for every leaf (of sum(out * R)), the prefill's states
        and one decode step's output and states.  Saved as (the rank's
        result, the whole layer's, cut to the rank's share)."""
        from repro_torch.distributed.sharding import (
            activation_sharding, gate_view, resolve_axes_tree, tp_plan,
        )
        from repro_torch.models import ssm, xlstm
        r = mesh.get_local_rank("model")
        for arch, layer, mixer in MIXERS:
            cfg = _cfg(arch, {}, "repro_torch")
            shapes, axes = Model(cfg, device="meta").param_shapes()
            plan = tp_plan(cfg, dict(zip(AXES, tuple(mesh.shape))), axes,
                           resolve_axes_tree(axes, shapes, cfg, mesh))
            whole_model = Model(cfg, device="cpu").init_params(
                torch.Generator().manual_seed(1))
            prefix = f"groups.0.{layer}.mixer."
            whole = {k[len(prefix):]: p.detach() for k, p in
                     whole_model.named_parameters() if k.startswith(prefix)}
            tag = f"layer/{arch}/{mixer}/{m}"
            res[f"{tag}/kinds"] = np.array(json.dumps(sorted(plan.kinds)))

            def mine(name, t):
                key = prefix + name
                d = plan.views.get(key)
                if d is None:
                    return t
                if key in plan.gates:
                    return gate_view(t, d, plan.gates[key], r, m)
                n = t.shape[d] // m
                return t.narrow(d, r * n, n)

            local = {n: mine(n, t).clone().requires_grad_()
                     for n, t in whole.items()}
            full = {n: t.clone().requires_grad_() for n, t in whole.items()}
            rng = np.random.default_rng(2)
            x = torch.from_numpy(rng.normal(
                0, 1, (2, 16, cfg.d_model)).astype(np.float32))
            x1 = torch.from_numpy(rng.normal(
                0, 1, (2, 1, cfg.d_model)).astype(np.float32))
            R = torch.from_numpy(rng.normal(
                0, 1, (2, 16, cfg.d_model)).astype(np.float32))
            state_dims = {"conv": 2, "ssm": 1}

            def run(params):
                if mixer == "mamba":
                    c0 = ssm.init_mamba_cache(
                        cfg, 2, torch.float32,
                        d_inner=params["conv_b"].shape[0])
                    out, st = ssm.mamba_apply(params, x, cfg, cache=c0)
                    o1, st1 = ssm.mamba_apply(params, x1, cfg, cache=st)
                else:
                    apply = getattr(xlstm, f"{mixer}_apply")
                    out, st = apply(params, x, cfg, return_state=True)
                    o1, st1 = apply(params, x1, cfg, cache=st)
                g = torch.autograd.grad((out * R).sum(),
                                        list(params.values()))
                return out, dict(zip(params, g)), st, o1, st1

            with activation_sharding(mesh, cfg, tp=plan):
                got = run(local)

            def state_chunk(n, t):
                d = state_dims.get(n, 1)       # heads / channels: dim 1
                if mixer != "mamba" and n == "conv":
                    d = 2
                size = t.shape[d] // m
                return t.narrow(d, r * size, size)

            split = f"{mixer}" in plan.kinds

            def whole_layer():
                """The whole layer's results, cut to the rank's share."""
                out, grads, st, o1, st1 = run(full)
                cut = {"out": out, "out1": o1}
                cut.update({f"grad/{n}": mine(n, grads[n]) for n in whole})
                for i, b in enumerate((st, st1)):
                    cut.update({f"state{i}/{n}": (
                        state_chunk(n, t.detach()) if split else t)
                        for n, t in b.items()})
                return {k: t.detach().numpy() for k, t in cut.items()}

            want = whole_layer()
            reach = spread(whole_layer)
            mixed = {"out": got[0], "out1": got[3]}
            mixed.update({f"grad/{n}": got[1][n] for n in whole})
            for i, a in enumerate((got[2], got[4])):
                mixed.update({f"state{i}/{n}": t for n, t in a.items()})
            for k, t in mixed.items():
                res[f"{tag}/{k}"] = t.detach().numpy()
                res[f"{tag}/{k}/want"] = want[k]
                res[f"{tag}/{k}/spread"] = reach[k]

    for name, (arch, shape, over, _) in CASES.items():
        cfg = _cfg(arch, over, "repro_torch")
        bundle = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"),
                                  make_mesh(shape, _axes(shape), "cpu"))
        if bundle.mesh.get_coordinate() is None:
            continue
        res[f"{name}/kinds"] = np.array(json.dumps(sorted(bundle.tp.kinds)))
        res[f"{name}/tp_leaves"] = np.array(json.dumps(sorted(
            bundle.tp.views)))
        state = init_state(bundle, arch, over)
        chunks(f"{name}/init", state, bundle)
        get = batches(cfg)
        plain = None
        if name in PLAIN:       # the mesh-free step from the same state
            plain_bundle = make_step_bundle(cfg, ShapeCfg("t", S, B,
                                                          "train"))
            plain = init_state(plain_bundle, arch, over)
            plain_chunks(f"{name}/plain/init", plain, bundle)
            res[f"{name}/specs"] = np.array(json.dumps(_leaf_specs(bundle)))
        plain_routes = None
        if name in ROUTED:      # the mesh-free step's routing decisions
            free = make_step_bundle(cfg, ShapeCfg("t", S, B, "train"))
            with record_routes() as rr:
                free.step_fn(init_state(free, arch, over), get(0))
            plain_routes = rr.calls
        if name in QUANTIZED:
            # the mesh-free gradient of this pod's rows (one microbatch,
            # one rank on "data"), from the same parameters
            pod = bundle.mesh.get_coordinate()[0]
            for k, t in _pod_grad(cfg, full_state(state)["params"], pod,
                                  shape[0]).items():
                res[f"{name}/pod_grad/{k}"] = t
            res[f"{name}/pod"] = np.array(pod)
        for i in range(STEPS):
            keep = i == 0 and name not in QUANTIZED
            with record_views(state, keep) as rec, \
                    record_quantizer() as q, record_routes() as rr:
                state, mt = bundle.step_fn(state, get(i))
            if plain_routes is not None and i == 0:
                res[f"{name}/routes"] = np.array(json.dumps({
                    "calls": len(rr.calls), "plain_calls": len(plain_routes),
                    "equal": [all(np.array_equal(a, b) for a, b in
                                  zip(got, want)) for got, want in
                              zip(rr.calls, plain_routes)]}))
            if name in QUANTIZED and i == 0:
                for k, t in q.trees[0].items():
                    res[f"{name}/quantizer_in/{k}"] = t
            if plain is not None:
                plain, _ = plain_bundle.step_fn(plain, get(i))
                plain_chunks(f"{name}/plain/step{i}", plain, bundle)
            res[f"{name}/views{i}"] = np.array(json.dumps(rec.seen))
            res[f"{name}/loss{i}"] = mt["loss"].numpy()
            res[f"{name}/step_count{i}"] = mt["step"].numpy()
            chunks(f"{name}/step{i}", state, bundle)
            if keep:
                gates = [k for k in bundle.tp.gates if k in rec.gate_views]
                res[f"{name}/gate_keys"] = np.array(json.dumps(gates))
                for key in gates:
                    view, whole = rec.gate_views[key]
                    res[f"{name}/gate_view/{key}"] = view
                    res[f"{name}/gate_whole/{key}"] = whole
                for key, g in zip(gates, rec.grad_chunks):
                    res[f"{name}/grad_chunk/{key}"] = g
                    # the model chunk of m, whole over the other axes
                    res[f"{name}/m_chunk/{key}"] = view_as(
                        state["opt"]["m"][key], bundle.tp.placements(
                            key, _axes(shape))).numpy().copy()
                    res[f"{name}/model_rank"] = np.array(
                        bundle.mesh.get_local_rank("model"))

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

    # --- view_as: c10d gathers, no redistribution (ROADMAP C18) -------------
    m22 = make_mesh((2, 2), AXES, "cpu")
    if m22.get_coordinate() is not None:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
        report = {"equal": [], "raised": []}
        calls = []
        saved = DTensor.redistribute

        def redistribute(*a, **k):
            calls.append(1)
            return saved(*a, **k)

        DTensor.redistribute = redistribute
        try:
            # (stored placements, asked placements): gathered values
            for have, want in (
                    ([Shard(0), Shard(1)], None),
                    ([Shard(0), Shard(1)], [Shard(0), Replicate()]),
                    ([Shard(0), Shard(0)], None),
                    ([Shard(0), Shard(0)], [Shard(0), Replicate()]),
                    ([Shard(1), Replicate()], None)):
                dt = DTensor.from_local(local_chunk(full, m22, have).clone(),
                                        m22, have, run_check=False)
                want_full = local_chunk(full, m22, want or
                                        [Replicate(), Replicate()])
                report["equal"].append(bool(torch.equal(
                    view_as(dt, want), want_full)))
            # a dim that cannot be gathered: another shard, or the major
            # of two axes on one dim while the minor keeps its shard
            for have, want in (([Shard(0), Shard(1)], [Shard(1), Shard(1)]),
                               ([Shard(0), Shard(0)], [Replicate(),
                                                       Shard(0)])):
                dt = DTensor.from_local(local_chunk(full, m22, have).clone(),
                                        m22, have, run_check=False)
                try:
                    view_as(dt, want)
                    report["raised"].append(False)
                except ValueError:
                    report["raised"].append(True)
        finally:
            DTensor.redistribute = saved
        report["redistributions"] = len(calls)
        res["view_as"] = np.array(json.dumps(report))

    # --- each split recurrent mixer against its whole layer -----------------
    for shape in MIXER_MESHES:
        mesh = make_mesh(shape, AXES, "cpu")
        if mesh.get_coordinate() is not None:
            mixer_layers(mesh, shape[-1])

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


# xLSTM: the moments against the reference at the per-entry bar that
# tests/test_torch_optim.py holds xlstm-125m's train steps to (ROADMAP
# C15), since at (1, 2) the flat bar misses 1 entry of v embed.embedding
# in 32768, where the reference itself moves by 3.2e-7 between its (1, 1)
# and (1, 2) meshes; the mesh-free step holds them at the flat bar too
# (test_tp_chunks_match_mesh_free_step)
C15_CASES = ("xlstm_12", "xlstm_14")


def _c15_parts(ref, got, tag, coord):
    """m and v of ``tag`` at ``coord`` against the reference, at
    ``moment_tolerances`` carried from the zero initial moments through
    each step so far (G: the largest |g| of every leaf and coordinate)."""
    import torch
    from test_torch_optim import moment_tolerances
    name, i = tag.split("/step")
    tol = None
    for j in range(int(i) + 1):
        prev = f"{name}/init" if j == 0 else f"{name}/step{j - 1}"
        cur = f"{name}/step{j}"
        new = {k[len(cur) + 7:]: torch.from_numpy(v) for k, v in ref.items()
               if k.startswith(cur + "/opt/m/")}
        old = {k: torch.from_numpy(ref[f"{prev}/opt/m/{k}"]) for k in new}
        if tol is None:
            tol = {part: {k: torch.zeros_like(t, dtype=torch.float64)
                          for k, t in new.items()} for part in ("m", "v")}
        tol = moment_tolerances(tol, old, new)
    out = {}
    for part in ("m", "v"):
        out[part] = {}
        for k in (k for k in ref if k.startswith(f"{tag}/opt/{part}/")
                  and k.endswith(f"@{coord}")):
            leaf = k[len(tag) + 7:]
            a, w = got[k], ref[k]
            ok = np.abs(a.astype(np.float64) - w) <= \
                tol[part][leaf].numpy()
            out[part][leaf.split("@")[0]] = (a, w, ok)
    return out


@pytest.mark.parametrize("name", [n for n in CASES if n not in QUANTIZED])
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
    parts = _c15_parts if name in C15_CASES else None
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(ref, got_ranks, name, i, prev, _lr(i + 1),
                   state_parts=parts)
    coords = sorted(next(k for k in got if k.startswith(f"{name}/step0/"))
                    .split("@")[1] for got in got_ranks)
    assert coords == sorted({k.split("@")[1] for k in ref
                             if k.startswith(f"{name}/step0/")})


@pytest.mark.parametrize("name", PLAIN)
def test_tp_chunks_match_mesh_free_step(sides, reach, name):
    """Each rank's chunks after each step against the port's mesh-free
    step from the same state, cut at the rank's coordinate, at the flat
    bars of the reference comparison (``_hold_step``), the moments and
    the parameter deltas plus twice each entry's spread (``_reach_parts``,
    ``reach``): what the recurrent
    mixers' tensor parallelism changes, float32 sums in another order,
    and nothing else.  xLSTM's gradient of ``embed.embedding`` carries
    that order through every layer (C14): at step 0 its v moved by up to
    7.3e-7 past the flat bar on some CPUs' GEMMs, and under
    ``MKL_CBWR=COMPATIBLE`` its parameter delta at step 1 past the delta
    bar, each within its spread."""
    _, ranks = sides
    got_ranks = _in_mesh(ranks, name)
    plain = {k.replace("/plain/", "/", 1): v for got in got_ranks
             for k, v in got.items() if k.startswith(f"{name}/plain/")}
    arch, shape, over, _ = CASES[name]
    moved = cut_reach(reach(arch, over), name, got_ranks, shape)
    for got in got_ranks:
        for k in (k for k in got if k.startswith(f"{name}/init/")):
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    for i in range(STEPS):
        prev = f"{name}/init" if i == 0 else f"{name}/step{i - 1}"
        _hold_step(plain, got_ranks, name, i, prev, _lr(i + 1),
                   state_parts=_reach_parts(moved), reach=moved)


def _reach_parts(reach):
    """The moments' check of ``_hold_step`` against the mesh-free step:
    ``_state_parts``' flat bars (rtol 2e-4, atol 2e-4 of the part's
    largest entry) plus twice each entry's spread, how far the mesh-free
    step's moments move when its products sum in other orders
    (``tests/_torch_rounding.py``)."""
    def parts(ref, got, tag, coord):
        out = {}
        for part in ("m", "v"):
            keys = [k for k in ref if k.startswith(f"{tag}/opt/{part}/")]
            scale = max(float(np.abs(ref[k]).max()) for k in keys)
            out[part] = {}
            for k in (k for k in keys if k.endswith(f"@{coord}")):
                leaf = k[len(tag) + 7:].split("@")[0]
                out[part][leaf] = (got[k], ref[k], within(
                    got[k], ref[k], 2e-4, 2e-4 * scale, reach[k]))
        return out
    return parts


@pytest.mark.parametrize("name", QUANTIZED)
def test_quantizer_input_is_the_reference_layout(sides, name):
    """Under int8 compression the step gathers each split gradient whole
    over ``model`` before the quantizer, the gate leaves' back in their
    storage chunks first: on every rank the tree the quantizer gets is,
    in the reference's layout, the mesh-free gradient of the pod's rows,
    at the gradient bar of ``tests/test_torch_train.py`` (rtol 2e-4, atol
    2e-4 of the largest |g|) plus twice each entry's spread, how far the
    mesh-free gradient moves when its products sum in other orders
    (``tests/_torch_rounding.py``).  The gap this bar holds is summation
    order alone: xlstm-125m's smoke gradient of ``embed.embedding`` is
    ill-conditioned (C14), and a row whose token sits at the start of a
    sequence moved by 5e-4 of its size between the mesh and the mesh-free
    step (row 39: 0.0168 against an atol of 0.0067), where the mesh-free
    step with its sums reordered moves it by 0.0296, and every parameter
    moved by one float32 step by 0.0154.  (Its chunks after the quantizer
    are not held to the reference's: ROADMAP C16.)"""
    _, ranks = sides
    arch, shape, over, _ = CASES[name]
    moved = {}
    for got in _in_mesh(ranks, name):
        pod = int(got[f"{name}/pod"])
        if pod not in moved:
            moved[pod] = pod_grad_reach(arch, over, pod, shape[0])
        want = {k[len(f"{name}/pod_grad/"):]: v for k, v in got.items()
                if k.startswith(f"{name}/pod_grad/")}
        have = {k[len(f"{name}/quantizer_in/"):]: v for k, v in got.items()
                if k.startswith(f"{name}/quantizer_in/")}
        assert want and sorted(have) == sorted(want)
        G = max(float(np.abs(v).max()) for v in want.values())
        for k, v in want.items():
            assert have[k].shape == v.shape, k
            assert_within(have[k], v, 2e-4, 2e-4 * G, moved[pod][k],
                          err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_views_are_model_chunks(sides, name):
    """The plan splits the kinds the config's counts allow; every leaf of
    those kinds computes on a view of 1/m of its elements, asked for with
    ``Shard`` on ``model`` or, for a gate leaf on more than one rank, cut
    from the whole leaf gate block by gate block; every other leaf whole
    (or its experts)."""
    _, ranks = sides
    arch, shape, over, kinds = CASES[name]
    cfg = _cfg(arch, over, "repro_torch")
    m = shape[-1]
    model = _axes(shape).index("model")
    for got in _in_mesh(ranks, name):
        assert json.loads(str(got[f"{name}/kinds"])) == sorted(kinds)
        tp_leaves = json.loads(str(got[f"{name}/tp_leaves"]))
        for i in range(STEPS):
            views = json.loads(str(got[f"{name}/views{i}"]))
            want = sorted(k for k in views
                          if _leaf_kind(cfg, k, kinds) in kinds)
            assert tp_leaves == want and want
            for key, (local, whole, placements, gate) in views.items():
                if key in tp_leaves:
                    assert local * m == whole, (key, local, whole)
                    if gate:
                        assert m > 1 and _gate_blocks(cfg, key), key
                    else:
                        assert not (m > 1 and _gate_blocks(cfg, key)), key
                        assert placements[model].startswith("Shard"), (
                            key, placements)
                elif ".ffn." in key and "ep_shard" in over:
                    assert local * m == whole, key      # this rank's experts
                else:
                    assert local == whole and not gate, key


GATE_CASES = [n for n, c in CASES.items()
              if c[1][-1] > 1 and c[3] & {"mamba", "mlstm", "slstm"}
              and "int8" not in n]


@pytest.mark.parametrize("name", GATE_CASES)
def test_gate_views_and_gradient_chunks(sides, name):
    """A gate leaf's compute view on ``model`` rank r is chunk r of each
    of its gate blocks of the whole leaf (x and z of channels r, the four
    gates of heads r), and the gradient the step makes of it is the
    leaf's storage chunk r: the one the step's AdamW consumed (after the
    first step m = 0.1 x the clipped gradient, one scale for every
    entry), the m chunk being held to the reference's shard by
    ``test_tp_chunks_match_reference_shards``."""
    _, ranks = sides
    arch, shape, over, _ = CASES[name]
    cfg = _cfg(arch, over, "repro_torch")
    m = shape[-1]
    for got in _in_mesh(ranks, name):
        r = int(got[f"{name}/model_rank"])
        keys = json.loads(str(got[f"{name}/gate_keys"]))
        assert keys and all(_gate_blocks(cfg, k) for k in keys)
        assert len(keys) == sum(1 for k in json.loads(str(
            got[f"{name}/tp_leaves"])) if _gate_blocks(cfg, k))
        ratios = []
        for key in keys:
            n = _gate_blocks(cfg, key)
            whole = got[f"{name}/gate_whole/{key}"]
            dim = whole.ndim - 1        # [x | z] and [i | f | z | o]: last
            blocks = np.split(whole, n * m, axis=dim)
            np.testing.assert_array_equal(
                got[f"{name}/gate_view/{key}"],
                np.concatenate([blocks[g * m + r] for g in range(n)], dim),
                err_msg=key)
            g, mom = got[f"{name}/grad_chunk/{key}"], \
                got[f"{name}/m_chunk/{key}"]
            assert g.shape == mom.shape and g.shape[dim] * m == \
                whole.shape[dim], (key, g.shape, whole.shape)
            big = np.abs(g) > 1e-3 * np.abs(g).max()
            ratios.append(mom[big] / g[big])
        ratios = np.concatenate(ratios)
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)


@pytest.mark.parametrize("name", ROUTED)
def test_routing_decisions_match_mesh_free_step(sides, name):
    """Where the plan splits the MoE layer (its experts, their ``d_ff``,
    the shared expert) every rank routes the whole (micro)batch, from the
    router's columns gathered over ``model`` under "expert": each MoE
    call's expert ids, slots and keep in the first step equal the
    mesh-free step's exactly (C7's rules kept: the padded rows compete,
    the capacity is the whole batch's)."""
    _, ranks = sides
    for got in _in_mesh(ranks, name):
        rep = json.loads(str(got[f"{name}/routes"]))
        assert rep["calls"] == rep["plain_calls"] > 0
        assert len(rep["equal"]) == rep["calls"] and all(rep["equal"]), rep


def test_view_as_gathers_by_c10d(sides):
    """A compute view that is not the leaf's own storage is gathered by
    c10d all-gathers, the minor mesh dim first (ROADMAP C18): on the
    (2, 2) mesh a DTensor split over both dims, or over both on one dim,
    gathers whole or keeps its major shard, equal to the chunks of the
    whole value; a placement it cannot reach by gathering raises; no
    DTensor is redistributed."""
    _, ranks = sides
    for got in ranks:
        rep = json.loads(str(got["view_as"]))
        assert rep["equal"] == [True] * 5, rep
        assert rep["raised"] == [True, True], rep
        assert rep["redistributions"] == 0, rep


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


@pytest.mark.parametrize("m", [s[-1] for s in MIXER_MESHES])
@pytest.mark.parametrize("arch,layer,mixer", MIXERS)
def test_split_mixer_matches_its_whole_layer(sides, arch, layer, mixer, m):
    """Each rank's split mixer (its chunks and gate views of a whole
    layer's leaves, under the plan) against the whole layer on the same
    input: the output, the gradient of every leaf (of sum(out * R), cut
    to the rank's share), the prefill's states (cut to the rank's heads
    or channels) and one decode step from them, at the single-function
    bar of ``tests/test_torch_models.py`` (float32 atol = rtol = 2e-5)
    plus twice each entry's spread: how far the whole layer's results
    move when its products sum in other orders (``_torch_rounding``).
    What differs is the order of the row-parallel sums (the mLSTM's
    ``wq``, ``wk``, ``wv`` and ``w_if``, mamba's ``x_proj`` and
    ``out_proj``: partial sums over the rank's features, then over the
    ranks) and the GEMM's blocking of a column slice; the mLSTM's
    exponential gates carry it to 5.5e-5 in ``grad/up_proj`` (entries up
    to 25), past the flat bar on every MKL code path."""
    _, ranks = sides
    tag = f"layer/{arch}/{mixer}/{m}"
    for got in ranks[:m]:
        assert mixer in json.loads(str(got[f"{tag}/kinds"]))
        keys = [k for k in got if k.startswith(tag + "/")
                and not k.endswith(("/want", "/kinds", "/spread"))]
        assert any("/grad/" in k for k in keys) and any(
            "/state1/" in k for k in keys)
        for k in keys:
            want = got[k + "/want"]
            assert got[k].shape == want.shape, (k, got[k].shape)
            assert_within(got[k], want, LAYER_TOL, LAYER_TOL,
                          got[k + "/spread"], err_msg=k)


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_tp_equals_plain_step(sides, name):
    """On a (1, 1) mesh the plan splits every kind present and the same
    code runs with its collectives as identities (a gate leaf's view is
    the leaf itself): two steps equal the mesh-free step's loss,
    parameters and moments bit for bit."""
    _, ranks = sides
    got = ranks[0]
    assert json.loads(str(got[f"one/{name}/kinds"])) == sorted(
        ONE_RANK[name])
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
    # 40 experts over 8 ranks, 5 a rank
    ("granite-moe-3b-a800m", (16, 8), {}, {"heads", "kv_heads", "expert"}),
    ("granite-moe-3b-a800m", (1, 1), {}, {"heads", "kv_heads", "vocab",
                                          "expert"}),
    # 40 experts do not divide 16: their d_ff (512) does
    ("granite-moe-3b-a800m", (16, 16), {}, {"expert_ffn"}),
    ("jamba-v0.1-52b", (16, 16), {}, {"heads", "ffn", "mamba", "vocab",
                                      "expert"}),
    # 40 heads do not divide 16; 128 experts, their shared expert's d_ff
    # (8192) and the dense layers' do
    ("llama4-maverick-400b-a17b", (16, 16), {}, {"ffn", "vocab", "expert",
                                                 "shared"}),
    # 4 heads: neither mixer splits over 16; the sLSTM's post-FFN (1024)
    # does
    ("xlstm-125m", (16, 16), {}, {"slstm_ffn", "vocab"}),
    ("xlstm-125m", (1, 4), {}, {"mlstm", "slstm", "slstm_ffn", "vocab"}),
    # seq_shard splits the same kinds, and the plan marks the sequence
    ("qwen2-7b", (16, 4), {"seq_shard": True}, ALL),
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
    import dataclasses
    from repro_torch.configs import get_config
    plan, shapes = _plan(arch, shape, over)
    assert plan.kinds == kinds
    assert plan.seq == bool(over.get("seq_shard"))
    cfg = dataclasses.replace(get_config(arch), **over)
    want = {k for k in shapes if _leaf_kind(cfg, k, kinds) in kinds}
    assert set(plan.views) == want
    assert plan.gates == {k: _gate_blocks(cfg, k) for k in want
                          if _gate_blocks(cfg, k)}
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
    those heads of the whole layer's output (forward, one process).

    The inputs are dyadic, k/8 with |k| <= 8, so every product and every
    partial sum of the projections (16 terms and a bias, at most 17 in
    magnitude, multiples of 1/64) is exact in float32 whatever the order
    of the GEMM's sums: q, k and v of the rank's heads must equal the
    whole layer's at the heads they read bit for bit, which is the claim
    (the index mapping).  With randn inputs the column slice of ``wq``
    and the whole ``wq`` summed in other orders and differed by 1.1e-5
    in one of 256 entries.  The rank's attention equals, bit for bit,
    the same attention call on the whole layer's q, k and v at those
    heads; against the whole layer's output, where the attention groups
    the heads otherwise, it is held at ``assert_close``'s float32 bar
    (atol 1e-5, rtol 1.3e-6), which bounds the float32 sums over the
    hd = 8 and S = 8 terms of two groupings of exact q, k and v: about
    (2 S + hd) u max|v| = 8.6e-6 at worst with max|v| < 6 (u = 2**-24),
    seen at most 1.1e-6."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.distributed.sharding import TPRank
    from repro_torch.models import attention as A
    hd, d, S = 8, 16, 8
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-7b")),
                              n_heads=nh, n_kv_heads=nkv, head_dim=hd,
                              d_model=d)
    rng = np.random.default_rng(0)

    def dyadic(shape):
        return torch.from_numpy(
            rng.integers(-8, 9, shape).astype(np.float32) / 8)

    p = {n: dyadic(shape) for n, shape in (
        ("wq", (d, nh * hd)), ("wk", (d, nkv * hd)), ("wv", (d, nkv * hd)),
        ("bq", (nh * hd,)), ("bk", (nkv * hd,)), ("bv", (nkv * hd,)))}
    x = dyadic((2, S, d))
    pos = torch.arange(S)[None, :]

    def attend(q, k, v):
        return A.full_attention(A.rope(q, pos, cfg.rope_theta),
                                A.rope(k, pos, cfg.rope_theta), v, cfg)

    qw, kw, vw = A._qkv(p, x, cfg, None)
    whole = attend(qw, kw, vw)
    n, G = nh // m, nh // nkv
    for r in range(m):
        local = dict(p, wq=p["wq"][:, r * n * hd:(r + 1) * n * hd],
                     bq=p["bq"][r * n * hd:(r + 1) * n * hd])
        q, k, v = A._qkv(local, x, cfg, TPRank(None, r))
        assert q.shape[2] == n and n % k.shape[2] == 0
        per = n // k.shape[2]           # local query heads per KV head
        # the KV head each local query head reads, in the whole layer
        read = [(r * n + i) // G for i in range(n)]
        assert torch.equal(q, qw[:, :, r * n:(r + 1) * n])
        for i in range(n):
            assert torch.equal(k[:, :, i // per], kw[:, :, read[i]]), (r, i)
            assert torch.equal(v[:, :, i // per], vw[:, :, read[i]]), (r, i)
        kv_heads = read[::per]
        got = attend(q, k, v)
        assert torch.equal(got, attend(qw[:, :, r * n:(r + 1) * n],
                                       kw[:, :, kv_heads],
                                       vw[:, :, kv_heads]))
        torch.testing.assert_close(got, whole[:, :, r * n:(r + 1) * n])
