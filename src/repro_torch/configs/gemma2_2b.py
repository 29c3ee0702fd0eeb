"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        # gemma2 alternates sliding-window (even) and global (odd) layers
        pattern=(Layer("attn_local", "mlp"), Layer("attn", "mlp")),
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        act="gelu",
        post_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        query_pre_attn_scalar=256.0,
        norm_eps=1e-6,
        param_dtype="bfloat16",
        notes="GeGLU, pre+post norms, softcaps, tied embeddings.",
    )
