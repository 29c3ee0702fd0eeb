"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell on 512 forced host devices and prices its HLO.  Torch has no
HLO: here one process is rank 0 of a ``"fake"`` process group of 256 or
512 ranks (``torch.testing._internal.distributed.fake_pg``; its
collectives move nothing), so no GPU is needed.  For each cell the dry
run:

  1. builds the production mesh (16×16 single-pod, or 2×16×16
     multi-pod, ``launch/mesh.py``),
  2. builds the cell's step bundle (train_step / prefill / serve_step,
     ``train/steps.py``) with its shardings,
  3. makes the step's inputs as fake CUDA tensors (``FakeTensorMode``:
     shapes and dtypes, nothing allocated), placed as the bundle's
     ``in_shardings`` place them, and runs the step once on them: the
     card's program, through the kernels' operators (their fake
     kernels: nothing launches),
  4. records the trace's per-device FLOPs, HBM bytes and collectives
     (``analysis/program.py``), priced by ``analysis.roofline`` at the
     H100's rates (``core/netem.py``), into a JSON artifact with the
     reference's keys.

A key the trace cannot measure is null: ``temp_size_in_bytes`` and
``generated_code_size_in_bytes`` (nothing is compiled or allocated),
``cost_analysis`` and ``compile_s``; ``lower_s`` is the trace time.  A
decode cell attends at its last position (``pos = seq_len - 1``).

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
Run everything: python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.program import (
    card_trace, trace_device, trace_program,
)
from repro_torch.analysis.roofline import roofline_terms
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.distributed.sharding import distribute
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models.params import dtype_of
from repro_torch.optim.compress import ef_init
from repro_torch.train import make_step_bundle
from repro_torch.train.steps import make_opt, place_params, place_state

DEFAULT_OUT = "results/dryrun"
CHIPS_PER_POD = 256


def fake_process_group(world_size: int) -> None:
    """Make this process rank 0 of a ``"fake"`` group of ``world_size``
    ranks (again if the current fake group has another size)."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group that is not fake is "
                               "already running")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _fake_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _fake_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_tree(v, device) for v in tree]
    return _fake(tree, device)


def _placed(tree, shardings):
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(v, s) for v, s in zip(tree, shardings)]
    return distribute(tree, shardings)


def step_inputs(bundle, device="cuda") -> tuple:
    """The inputs of a mesh bundle's ``step_fn`` as tensors on ``device``
    (under a ``FakeTensorMode``: fake ones), placed by ``in_shardings``:
    the train state and batch; the parameters and prompt; or the
    parameters, a cache of ``seq_len`` positions, the next tokens and the
    last position."""
    cfg, shape = bundle.cfg, bundle.shape
    B, S = shape.global_batch, shape.seq_len
    shapes, _ = Model(cfg, device="meta").param_shapes()
    params = _fake_tree(shapes, device)
    if cfg.input_mode == "tokens":
        def tokens(n):
            return torch.zeros((B, n), dtype=torch.int32, device=device)
    else:
        def tokens(n):
            return torch.zeros((B, n, cfg.d_model), device=device,
                               dtype=dtype_of(cfg.compute_dtype))
    if shape.kind == "train":
        full = {"params": params, "opt": make_opt(cfg).init(params)}
        if "ef" in bundle.in_shardings[0]:
            full["ef"] = ef_init(params)
        batch = {"inputs": tokens(S), "labels": torch.zeros(
            (B, S), dtype=torch.int32, device=device)}
        return place_state(cfg, full, bundle.in_shardings[0]), batch
    model = place_params(cfg, params, bundle.in_shardings[0])
    if shape.kind == "prefill":
        return model, tokens(S)
    cache = _placed(_fake_tree(Model(cfg, device="meta").init_cache(
        B, S, dtype_of(cfg.cache_dtype)), device), bundle.in_shardings[1])
    return model, cache, tokens(1), S - 1


def _leaves(tree) -> list:
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            out += [p for p in t.parameters()]
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _local_bytes(ts) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in ts)


def _memory(inputs, outputs) -> dict:
    """The reference's memory_analysis keys, per device: arguments and
    outputs are this rank's chunks; an output that is an input (updated
    in place, as the donated state and cache) is aliased; temporaries
    and code are not measured."""
    ins, outs = _leaves(inputs), _leaves(outputs)
    ids = {id(t) for t in ins}
    return {"argument_size_in_bytes": _local_bytes(ins),
            "output_size_in_bytes": _local_bytes(outs),
            "temp_size_in_bytes": None,
            "alias_size_in_bytes": _local_bytes(
                [t for t in outs if id(t) in ids]),
            "generated_code_size_in_bytes": None}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = DEFAULT_OUT, save_hlo: bool = False,
             overrides: dict | None = None, tag: str = "") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id + ".json")

    ok, why = cfg.supports_shape(shape)
    if not ok:
        result = {"cell": cell_id, "arch": arch, "shape": shape_name,
                  "mesh": mesh_name, "status": "SKIP", "reason": why}
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[dryrun] {cell_id}: SKIP ({why})")
        return result

    t0 = time.time()
    try:
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size()
        bundle = make_step_bundle(cfg, shape, mesh)
        device = trace_device()
        with FakeTensorMode(allow_non_fake_inputs=True), card_trace(device):
            inputs = step_inputs(bundle, device)
            analysis, outputs, rec = trace_program(
                bundle.step_fn, *inputs, chips_per_pod=CHIPS_PER_POD,
                keep_ops=save_hlo)
            mem = _memory(inputs, outputs)
        t_lower = time.time() - t0
    except Exception:                                         # noqa: BLE001
        result = {"cell": cell_id, "arch": arch, "shape": shape_name,
                  "mesh": mesh_name, "status": "FAIL",
                  "error": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[dryrun] {cell_id}: FAIL")
        print(result["error"].splitlines()[-1])
        return result

    kind = "train" if shape.kind == "train" else "serve"
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = cfg.model_flops_per_token(
        "train" if kind == "train" else "serve") * tokens
    rl = roofline_terms(analysis, model_flops_total=model_flops,
                        n_chips=n_chips)

    result = {
        "cell": cell_id, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "status": "OK",
        "kind": shape.kind,
        "n_chips": n_chips,
        "tokens_per_step": tokens,
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "memory_analysis": mem,
        "cost_analysis": None,
        "hlo_analysis": {
            "flops_per_device": analysis.flops,
            "hbm_bytes_per_device": analysis.hbm_bytes,
            "ici_bytes_per_device": analysis.ici_bytes,
            "dcn_bytes_per_device": analysis.dcn_bytes,
            "collective_operand_bytes": analysis.collective_operand_bytes,
            "top_collectives": [dataclasses.asdict(c)
                                for c in analysis.collectives[:12]],
            "top_dots": analysis.dots[:12],
        },
        "model_flops_total": model_flops,
        "roofline": rl.to_json(),
    }
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    if save_hlo:
        with gzip.open(os.path.join(out_dir, cell_id + ".ops.gz"),
                       "wt") as f:
            f.write("\n".join(rec.ops) + "\n")
    tps = result["roofline"]
    print(f"[dryrun] {cell_id}: OK  trace={t_lower:.0f}s  "
          f"bottleneck={tps['bottleneck']}  "
          f"t_comp={tps['t_compute']:.4f}s t_mem={tps['t_memory']:.4f}s "
          f"t_ici={tps['t_ici']:.4f}s t_dcn={tps['t_dcn']:.4f}s  "
          f"frac={tps['roofline_fraction']:.3f}")
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) for the chosen mesh")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--save-hlo", action="store_true",
                   help="write the traced operator list, gzipped, as "
                        "<cell>.ops.gz beside the JSON, in place of the "
                        "reference's HLO (torch has none)")
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if not args.all and args.arch is None and args.shape is None:
        p.error("pass --arch/--shape or --all")

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            mesh_name = "2x16x16" if args.multi_pod else "16x16"
            path = os.path.join(
                args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("OK", "SKIP"):
                    print(f"[dryrun] {prev['cell']}: cached "
                          f"({prev['status']})")
                    continue
            r = run_cell(arch, shape, multi_pod=args.multi_pod,
                         out_dir=args.out, save_hlo=args.save_hlo)
            n_fail += r["status"] == "FAIL"
    print(f"[dryrun] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
