"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Maverick interleaves MoE and dense FFN layers (interleave step 2) and routes
top-1 over 128 experts with an always-on shared expert.
"""
from repro_torch.configs.base import ArchConfig, Layer, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        pattern=(Layer("attn", "moe"), Layer("attn", "mlp")),
        moe=MoECfg(num_experts=128, top_k=1, d_ff=8192,
                   capacity_factor=1.25, shared_expert=True),
        rope_theta=500_000.0,
        norm_eps=1e-5,
        param_dtype="bfloat16",
        opt_dtype="bfloat16",   # 400B total params: bf16 optimizer state to fit
        fsdp_params=True,
        microbatches=8,         # 1M-token global batch: fit activations in HBM
        notes="Largest assigned arch (400B total / ~17B active).",
    )
