"""Architecture / run configuration schema.

One ``ArchConfig`` instance per assigned architecture lives in
``configs/<id>.py``; ``shapes.py`` defines the assigned input-shape set.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attn-free
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # routed-expert ffn width (deepseek: 1408)
    moe_strategy: str = "expert_parallel"  # or "expert_tp"
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    kv_lora: int = 0             # 0 -> standard GQA attention
    q_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- misc attention ---
    qk_norm: bool = False        # qwen3
    rope: str = "rope"           # rope | mrope | none
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window (local attention)
    # hybrid pattern (recurrentgemma): block types cycled over layers
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")

    # --- norms ---
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln (olmo)

    # --- ssm (rwkv6) ---
    rwkv_head_dim: int = 64

    # --- enc-dec (seamless) ---
    n_encoder_layers: int = 0

    # --- frontend stubs (vlm / audio): inputs are precomputed embeddings ---
    embed_inputs: bool = False

    # --- parallelism preset (launch/mesh.sharding_rules) ---
    #   fsdp_tp  — FSDP over "data" + tensor-parallel over "model" (default)
    #   dp       — pure data parallel: batch over every mesh axis, params
    #              ZeRO-sharded over "data" only (small models)
    #   serve_2d — weight-stationary decode: weights 2D-sharded, FFN/MoE
    #              activations gathered over "data" around the block
    parallelism: str = "fsdp_tp"

    # --- attention lowering (xla chunked path) ---
    attn_block_k: int = 128     # kv-chunk size; larger = fewer carry r/w
    attn_p_bf16: bool = False   # cast softmax weights to bf16 for the PV dot

    # --- training / numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for the very large archs
    remat: str = "none"                # none | layer  (activation ckpting)
    microbatches: int = 1              # grad-accumulation slices per step
    tie_embeddings: bool = False

    # --- serving ---
    kv_cache_dtype: str = "bfloat16"
    page_size: int = 64

    # --- applicability flags (DESIGN.md §Arch-applicability) ---
    subquadratic: bool = False   # may run long_500k

    # --- settings only the port's own architectures take ---------------
    # Class attributes, not fields: the ten configs mirrored from the JAX
    # package keep its fields (and ``asdict``), and read these defaults;
    # ``PortArchConfig`` makes each a field with the same default.
    first_dense = 0              # leading dense layers (FFN of d_ff)
    scoring = "softmax"          # router: softmax | sigmoid (with a bias)
    n_group = 1                  # expert groups of the router
    topk_group = 1               # groups a token may pick its experts from
    routed_scaling = 1.0         # the routed gates' factor
    bias_speed = 0.0             # gamma of the selection bias's update
    balance_alpha = 0.0          # the sequence-wise balance loss's alpha
    yarn_factor = 1.0            # YaRN: rope_scaling.factor (<= 1: plain)
    yarn_original = 4096         # original_max_position_embeddings
    yarn_beta_fast = 32.0
    yarn_beta_slow = 1.0
    yarn_mscale = 1.0
    yarn_mscale_all_dim = 0.0
    experts_held = 0             # routed experts held here (0: all)
    first_held = 0               # the id of the first held expert

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def held(self) -> int:
        """The routed experts this chip holds (all where none is set)."""
        return self.experts_held or self.n_experts

    @property
    def bias_layers(self) -> int:
        """The expert layers whose router selects with a bias (sigmoid
        scoring, DeepSeek-V3's): every layer after the leading dense ones,
        or 0."""
        if self.scoring != "sigmoid" or not self.n_experts:
            return 0
        return self.n_layers - self.first_dense

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_A = ArchConfig


@dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An ``ArchConfig`` of an architecture that only the port has, with
    the port-only settings as fields (their meaning and defaults at
    ``ArchConfig``)."""
    first_dense: int = _A.first_dense
    scoring: str = _A.scoring
    n_group: int = _A.n_group
    topk_group: int = _A.topk_group
    routed_scaling: float = _A.routed_scaling
    bias_speed: float = _A.bias_speed
    balance_alpha: float = _A.balance_alpha
    yarn_factor: float = _A.yarn_factor
    yarn_original: int = _A.yarn_original
    yarn_beta_fast: float = _A.yarn_beta_fast
    yarn_beta_slow: float = _A.yarn_beta_slow
    yarn_mscale: float = _A.yarn_mscale
    yarn_mscale_all_dim: float = _A.yarn_mscale_all_dim
    experts_held: int = _A.experts_held
    first_held: int = _A.first_held


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig):
    """The assigned shape set, with long_500k only for sub-quadratic archs
    (the 8 full-attention skips are recorded in EXPERIMENTS.md)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out
