"""Architecture / shape / policy configuration for the repro framework.

Every assigned architecture is expressed as an ``ArchConfig``: a repeating
``pattern`` of per-layer (mixer, ffn) pairs covering ``n_layers`` layers, plus
family-specific sub-configs (MoE / Mamba / xLSTM).  The same config object
drives model init, train/serve step construction, sharding-rule resolution,
the multi-pod dry-run and the roofline analyzer, so every number lives here
exactly once.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts feed-forward config (GShard-style top-k routing)."""

    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden dim
    capacity_factor: float = 1.25
    shared_expert: bool = False     # llama4-style always-on shared expert
    router_dtype: str = "float32"
    pad_experts_to: int = 0         # pad E to a shardable count (§Perf);
                                    # pad experts get -inf router logits
    ep_shard: bool = False          # explicit expert parallelism via
                                    # shard_map (§Perf): one psum combine

    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_experts_to)


@dataclass(frozen=True)
class MambaCfg:
    """Mamba-1 selective SSM config (jamba-style blocks)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or math.ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMCfg:
    """xLSTM config: mLSTM (matrix memory) + sLSTM (scalar memory) blocks."""

    proj_factor: float = 2.0        # mLSTM pre-up-projection factor
    conv_dim: int = 4               # causal conv width in mLSTM blocks
    slstm_proj_factor: float = 1.3334  # sLSTM post-up-projection factor


@dataclass(frozen=True)
class Layer:
    """One entry of the repeating layer pattern.

    mixer: attn | attn_local | mamba | mlstm | slstm
    ffn:   mlp | moe | none
    """

    mixer: str
    ffn: str


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; every LM arch carries all four cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Main architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[Layer, ...] = (Layer("attn", "mlp"),)
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attn_softcap: float = 0.0       # gemma2 attention-logit soft cap (0 = off)
    final_softcap: float = 0.0      # gemma2 final-logit soft cap (0 = off)
    sliding_window: int = 4_096     # window for attn_local layers
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu
    gated_mlp: bool = True          # SwiGLU/GeGLU vs plain 2-matrix MLP
    post_norm: bool = False         # gemma2 post-attn/post-ffn extra norms
    embed_scale: bool = False       # gemma2 multiplies embeddings by sqrt(d)
    tie_embeddings: bool = False
    input_mode: str = "tokens"      # tokens | embeddings (vlm/audio stubs)
    query_pre_attn_scalar: float = 0.0  # 0 -> 1/sqrt(head_dim)
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    supports_long_context: bool = False  # sub-quadratic decode memory path

    # --- training / memory policies -------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    cache_dtype: str = "bfloat16"   # decode KV/state cache dtype
    remat: str = "full"             # none | full | dots
    fsdp_params: bool = False       # additionally shard params over data axis
    seq_shard: bool = False         # sequence parallelism over "model"
    attn_impl: str = "chunked"      # chunked | flash_xla (§Perf)
    scan_layers: bool = True
    use_pallas: bool = False        # TPU fast path; CPU dry-run uses XLA ref
    microbatches: int = 1
    grad_compression: str = "none"  # none | int8
    notes: str = ""

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.n_layers // len(self.pattern)

    @property
    def d_inner_mamba(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def d_inner_mlstm(self) -> int:
        assert self.xlstm is not None
        return int(self.xlstm.proj_factor * self.d_model)

    def layers(self) -> tuple[Layer, ...]:
        """The full per-layer sequence (pattern tiled over n_layers)."""
        return tuple(
            self.pattern[i % len(self.pattern)] for i in range(self.n_layers)
        )

    # --- parameter counting (analytic; used for MODEL_FLOPS and reports) --

    def _mixer_params(self, mixer: str) -> int:
        d, hd = self.d_model, self.head_dim_
        if mixer in ("attn", "attn_local"):
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads * hd + 2 * self.n_kv_heads * hd) if self.qkv_bias else 0
            return q + kv + o + bias
        if mixer == "mamba":
            m = self.mamba
            di = self.d_inner_mamba
            dtr = m.resolved_dt_rank(d)
            return (
                d * 2 * di              # in_proj (x, z)
                + m.d_conv * di         # depthwise conv
                + di * (dtr + 2 * m.d_state)  # x_proj
                + dtr * di + di         # dt_proj (+bias)
                + di * m.d_state + di   # A_log, D
                + di * d                # out_proj
            )
        if mixer == "mlstm":
            di = self.d_inner_mlstm
            x = self.xlstm
            return (
                2 * self.d_model * di          # up_proj (x, z)
                + x.conv_dim * di              # causal conv
                + 3 * di * di                  # q, k, v projections
                + 2 * di * self.n_heads        # i, f gate projections
                + di                           # learnable skip/out norm
                + di * self.d_model            # down proj
            )
        if mixer == "slstm":
            di = self.d_model
            h = int(self.xlstm.slstm_proj_factor * di)
            return 4 * di * di + 4 * di * di + 2 * di * h  # W, R (4 gates), ffn
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str) -> int:
        d = self.d_model
        if ffn == "mlp":
            n = 3 if self.gated_mlp else 2
            return n * d * self.d_ff
        if ffn == "moe":
            m = self.moe
            per_expert = 3 * d * m.d_ff if self.gated_mlp else 2 * d * m.d_ff
            total = m.num_experts * per_expert + d * m.num_experts  # + router
            if m.shared_expert:
                total += per_expert
            return total
        if ffn == "none":
            return 0
        raise ValueError(ffn)

    def n_params(self) -> int:
        """Total parameter count (embeddings included once if tied)."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # unembed
        for layer in self.layers():
            total += self._mixer_params(layer.mixer)
            total += self._ffn_params(layer.ffn)
            total += 2 * self.d_model  # pre-norms
            if self.post_norm:
                total += 2 * self.d_model
        total += self.d_model  # final norm
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE counts only routed top_k)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for layer in self.layers():
            total += self._mixer_params(layer.mixer)
            if layer.ffn == "moe":
                m = self.moe
                per_expert = (3 if self.gated_mlp else 2) * self.d_model * m.d_ff
                total += m.top_k * per_expert + self.d_model * m.num_experts
                if m.shared_expert:
                    total += per_expert
            else:
                total += self._ffn_params(layer.ffn)
            total += 2 * self.d_model
            if self.post_norm:
                total += 2 * self.d_model
        total += self.d_model
        return total

    def model_flops_per_token(self, kind: str = "train") -> float:
        """6·N_active for training, 2·N_active for inference forward."""
        mult = 6.0 if kind == "train" else 2.0
        return mult * self.n_active_params()

    # ------------------------------------------------------------------

    def supports_shape(self, shape: ShapeCfg) -> tuple[bool, str]:
        """Whether this (arch, shape) cell is runnable (see DESIGN.md)."""
        if shape.name == "long_500k" and not self.supports_long_context:
            return False, (
                "pure full-attention arch: O(S) KV cache at 524288 tokens is "
                "supported but assigned only to SSM/hybrid archs per task spec"
            )
        return True, ""


# ---------------------------------------------------------------------------
# Smoke-test reduction
# ---------------------------------------------------------------------------


def reduce_for_smoke(cfg: ArchConfig, *, d_model: int = 128,
                     vocab: int = 512, n_groups: int = 2) -> ArchConfig:
    """Shrink a full config to a laptop-runnable config of the same family.

    Keeps the layer pattern (so every mixer/ffn kind in the family is
    exercised) but shrinks width, depth, vocab and expert count.
    """
    period = len(cfg.pattern)
    head_dim = 32
    n_heads = max(2, min(cfg.n_heads, d_model // head_dim))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64,
        )
    mamba = replace(cfg.mamba, d_state=8) if cfg.mamba is not None else None
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=period * n_groups,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=vocab,
        sliding_window=64,
        moe=moe,
        mamba=mamba,
        param_dtype="float32",
        compute_dtype="float32",
        fsdp_params=False,
        remat="none",
        microbatches=1,
        use_pallas=False,
    )
