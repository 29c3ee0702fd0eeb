"""granite-34b [dense] — llama-style code model with MQA (kv=1).

[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, Layer


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        pattern=(Layer("attn", "mlp"),),
        gated_mlp=False,  # granite-34b-code uses a plain GELU MLP (bigcode lineage)
        act="gelu",
        rope_theta=10_000.0,
        norm_eps=1e-5,
        param_dtype="bfloat16",
        fsdp_params=True,
        notes="88L MQA code model; deepest assigned arch.",
    )
