"""xlstm-125m [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

Layer layout adapted from xLSTM[7:1]-style interleaving: one sLSTM block per
4-layer group, remaining blocks mLSTM (the 125M config is tagged unverified
in the assignment; see DESIGN.md §Arch-applicability).  xLSTM blocks embed
their own up/down projections, so ffn="none" and d_ff=0.
"""
from repro_torch.configs.base import ArchConfig, Layer, XLSTMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        pattern=(
            Layer("mlstm", "none"),
            Layer("mlstm", "none"),
            Layer("mlstm", "none"),
            Layer("slstm", "none"),
        ),
        xlstm=XLSTMCfg(proj_factor=2.0, conv_dim=4),
        supports_long_context=True,  # recurrent state: O(1) memory decode
        norm_eps=1e-6,
        notes="Matrix-memory mLSTM + scalar-memory sLSTM; O(1) decode state.",
    )
