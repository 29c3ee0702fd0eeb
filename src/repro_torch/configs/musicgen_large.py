"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]
The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (the codebook-interleaving is folded into the
stub).  kv=32 with 32 heads: plain MHA.
"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        pattern=(Layer("attn", "mlp"),),
        input_mode="embeddings",
        gated_mlp=False,   # musicgen uses plain GELU MLP
        act="gelu",
        norm_eps=1e-5,
        notes="Decoder-only over EnCodec tokens; sinusoidal pos-emb adapted to rope (DESIGN.md).",
    )
