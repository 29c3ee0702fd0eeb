"""pixtral-12b [vlm] — mistral-nemo decoder backbone; ViT frontend stubbed.

[hf:mistralai/Pixtral-12B-2409; unverified]
The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, seq, d_model).
"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=(Layer("attn", "mlp"),),
        input_mode="embeddings",
        rope_theta=1_000_000_000.0,
        norm_eps=1e-5,
        param_dtype="bfloat16",
        fsdp_params=True,
        notes="Backbone only; patch embeddings arrive precomputed.",
    )
