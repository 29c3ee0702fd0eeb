"""A cell at a size the CPU holds: the configuration's widths, depth,
vocabulary and experts cut, float32 throughout, and the traffic cut to
match; the port's ArchConfig cut alike.  Two sizes: ``smoke`` for the
runs of the harness, and ``control``, deep and wide enough that the
control (fp8 products) fails the cell's limits as at the full size."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# (hidden, layers, query heads, vocabulary, experts, experts a token)
SIZES = {"smoke": (64, 2, 4, 256, 4, 2), "control": (256, 8, 8, 1024, 8, 2)}
TRAFFIC = {
    "train": {"batch": 2, "seq": 32},
    "prefill": {"lengths": {"min": 32, "max": 96, "count": 3, "multiple": 8}},
    "decode": {"batch": 4, "history": 24, "cache_len": 40, "new_tokens": 8},
}


def smoke_run(bench, cell: str, seed: int, fault=None, size="smoke"):
    """harness.make_run for ``cell`` at ``size``, on the CPU."""
    from benchlib import harness
    from repro_torch.configs import get_config
    D, L, H, V, E, k = SIZES[size]
    hd, F = D // H, 2 * D
    c = bench.cell(cell).config
    config = {"hidden_size": D, "num_hidden_layers": L,
              "num_attention_heads": H, "num_key_value_heads": 2,
              "head_dim": hd, "intermediate_size": F, "vocab_size": V,
              "param_dtype": "float32", "compute_dtype": "float32",
              "cache_dtype": "float32"}
    full = get_config(c["arch"])
    moe = None
    if full.moe is not None:
        config.update(num_local_experts=E, num_experts_per_tok=k)
        moe = dataclasses.replace(full.moe, num_experts=E, top_k=k, d_ff=F)
    arch = dataclasses.replace(
        full, d_model=D, n_layers=L, n_heads=H, n_kv_heads=2, head_dim=hd,
        d_ff=0 if moe else F, vocab_size=V, moe=moe, param_dtype="float32",
        compute_dtype="float32", cache_dtype="float32")
    kind = bench.cell(cell).traffic["kind"]
    return harness.make_run(bench, cell, seed, "cpu", arch=arch,
                            config=config, traffic=TRAFFIC[kind],
                            fault=fault)
