"""Every module of the JAX package has a counterpart in the port that
defines its top-level names, save an explicit table of omissions by
design.

For each module ``src/repro/<path>.py`` the port's ``src/repro_torch/
<path>.py`` must exist, and every name that the module defines at its top
level (functions, classes, assigned names; also inside a top-level ``if``
or ``try``) must be defined at the port's top level too, unless
:data:`OMITTED` lists it with its reason.  An entry of :data:`OMITTED`
that the port now defines, or that the reference no longer does, fails
too, so the table cannot go stale.  Source files are parsed, not
imported: this test imports neither package.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

PALLAS = "a Pallas internal: the port's kernel is CUDA C++ (csrc/*.cu)"
DT = "dtypes come from models.params.dtype_of"
PYTREE = ("a pytree helper of the parameter tree: the port's Init leaves "
          "carry the logical axes (Model.param_axes)")
# {module path under src/repro: {name: why the port leaves it out}}
OMITTED = {
    "core/netem.py": {
        "ICI_LAT": "nothing in either package reads it, and no public "
                   "NVLink or DGX H100 latency figure is in the repo",
        "DCN_LAT": "nothing in either package reads it, and no public "
                   "NVLink or DGX H100 latency figure is in the repo",
    },
    "distributed/sharding.py": {
        "shard_map_compat": "the port's mesh step is explicit SPMD (one "
                            "process per device, collectives written out)",
    },
    "kernels/cohort.py": {
        "_pane_starts_jax": "the JAX backend: ported as the torch backend "
                            "(A8b)",
    },
    "kernels/netcalc.py": {
        "_delay_many_jax": "the JAX backend: ported as the torch backend "
                           "(A8b)",
    },
    "kernels/flash_attention.py": {
        "_fwd_kernel": PALLAS,
        "pick_block": PALLAS + "; the CUDA kernel's tiles are fixed",
        "NEG_INF": PALLAS + "; the CUDA source has its own",
    },
    "kernels/flash_decode.py": {
        "_decode_kernel": PALLAS,
        "NEG_INF": PALLAS + "; the CUDA source has its own",
    },
    "kernels/ops.py": {
        "_fa_fwd": "the reference's custom_vjp forward rule: the port's "
                   "autograd Function (ops._FlashAttention) holds it",
    },
    "launch/dryrun.py": {
        "_memory_analysis_dict": "XLA's compiled memory analysis: the "
                                 "port's trace has none (it counts the "
                                 "program's own bytes)",
    },
    "models/params.py": {
        "ParamMeta": PYTREE,
        "pmeta": PYTREE,
        "stacked_axes": PYTREE + "; groups are unrolled, not stacked",
        "unzip": PYTREE,
        "_is_meta": PYTREE,
    },
    **{f"models/{m}.py": {"_dt": DT} for m in (
        "attention", "layers", "moe", "ssm", "transformer", "xlstm")},
    "train/steps.py": {
        "_dt": DT,
        "_inputs_struct": "jax.ShapeDtypeStruct inputs: the port's specs "
                          "are meta tensors (train_input_specs)",
        "_resolve_one": "resolves a jax PartitionSpec tree leaf: the port "
                        "resolves its state tree in resolve_axes_tree",
        "_spec_tree": "builds jax sharding trees: the port's are "
                      "NamedSharding trees of its own (_named)",
        "_state_shapes": "jax.eval_shape of the state: the port's state "
                         "shapes are meta tensors (Model.param_shapes)",
    },
}


def top_names(path: Path) -> set:
    """The names a module binds at its top level."""
    out = set()

    def bind(target):
        if isinstance(target, ast.Name):
            out.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                bind(t)

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    bind(t)
            elif isinstance(node, ast.AnnAssign):
                bind(node.target)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                visit(node.orelse)
                visit(node.finalbody)
                for h in node.handlers:
                    visit(h.body)

    visit(ast.parse(path.read_text()).body)
    return out


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_counterpart_with_its_names(module):
    port = PORT / module
    assert port.exists(), f"no counterpart of src/repro/{module}"
    ref_names, port_names = top_names(REF / module), top_names(port)
    omitted = OMITTED.get(module, {})
    missing = sorted(ref_names - port_names - set(omitted))
    assert not missing, (f"src/repro_torch/{module} lacks {missing}, "
                         "which OMITTED does not list")
    stale = sorted(n for n in omitted
                   if n in port_names or n not in ref_names)
    assert not stale, (f"OMITTED lists {stale} of {module}, which the port "
                       "defines or the reference does not")
    assert all(why.strip() for why in omitted.values())


def test_omissions_name_modules_of_the_reference():
    assert set(OMITTED) <= set(MODULES)
