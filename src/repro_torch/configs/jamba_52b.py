"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with 16e top-2 MoE.

[arXiv:2403.19887; hf]
Period-8 block: attention at offset 4, Mamba elsewhere; MoE replaces the MLP
on every other layer (offsets 1,3,5,7).
"""
from repro_torch.configs.base import ArchConfig, Layer, MambaCfg, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        pattern=(
            Layer("mamba", "mlp"),
            Layer("mamba", "moe"),
            Layer("mamba", "mlp"),
            Layer("mamba", "moe"),
            Layer("attn", "mlp"),
            Layer("mamba", "moe"),
            Layer("mamba", "mlp"),
            Layer("mamba", "moe"),
        ),
        moe=MoECfg(num_experts=16, top_k=2, d_ff=14336, capacity_factor=1.25),
        mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
        supports_long_context=True,   # only 4 attention layers hold KV cache
        norm_eps=1e-6,
        param_dtype="bfloat16",
        fsdp_params=True,
        notes="Hybrid SSM/attention; long-context decode via tiny KV footprint.",
    )
