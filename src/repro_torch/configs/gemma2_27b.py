"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        pattern=(Layer("attn_local", "mlp"), Layer("attn", "mlp")),
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        act="gelu",
        post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        query_pre_attn_scalar=144.0,  # d_model / n_heads = 4608/32
        norm_eps=1e-6,
        param_dtype="bfloat16",
        fsdp_params=True,
        notes="GeGLU, pre+post norms, softcaps, query scale d_model/n_heads.",
    )
