"""qwen2-7b [dense] — GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        pattern=(Layer("attn", "mlp"),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        act="silu",
        param_dtype="bfloat16",
        fsdp_params=True,
        notes="28L GQA kv=4, SwiGLU, QKV bias, rope theta 1e6.",
    )
