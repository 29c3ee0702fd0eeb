"""granite-moe-3b-a800m [moe] — 40-expert top-8 fine-grained MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, Layer, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        pattern=(Layer("attn", "moe"),),
        moe=MoECfg(num_experts=40, top_k=8, d_ff=512, capacity_factor=1.25),
        rope_theta=10_000.0,
        norm_eps=1e-6,
        param_dtype="bfloat16",
        notes="Fine-grained MoE: tiny experts (d_ff=512), high top-k.",
    )
