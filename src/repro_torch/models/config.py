"""Model / shape configuration for the assigned architecture zoo.

A copy of the JAX package's ``models/config.py`` (pure Python), so the
port imports nothing of it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 = full attention
    global_every: int = 0        # gemma3: layer is global iff (i+1) % global_every == 0

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_dims: int = 64

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0      # leading layers with dense FFN (deepseek: 1)
    capacity_factor: float = 1.25

    # SSM
    ssm: str = ""                # "" | mamba1 | mamba2
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    ssm_heads: int = 8           # mamba2 head count
    attn_every: int = 0          # zamba2: shared attn block every k layers

    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # modality frontend stubs ([audio]/[vlm]: precomputed embeddings)
    frontend: str = ""           # "" | patches | frames
    frontend_len: int = 0
    frontend_dim: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid decode state is O(1) or
        sequence-shardable)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch decodes (seamless via its decoder)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: shared + top_k experts)."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.head_dim
    n = 0

    def attn_params() -> int:
        if cfg.mla:
            kv_in = cfg.kv_lora
            p = d * (cfg.q_lora or d) // (d if not cfg.q_lora else 1)
            q = (cfg.q_lora * cfg.n_heads * hd + d * cfg.q_lora) if cfg.q_lora else d * cfg.n_heads * hd
            k = d * cfg.kv_lora + cfg.kv_lora * cfg.n_heads * hd * 2  # k_nope + v up-proj
            r = d * cfg.rope_dims
            o = cfg.n_heads * hd * d
            return q + k + r + o
        qkv = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
        return qkv + cfg.n_heads * hd * d

    def mlp_params(dff: int) -> int:
        return 3 * d * dff

    def ssm_params() -> int:
        di = cfg.d_inner
        return 2 * d * di + di * d + di * (cfg.d_conv + 2 * cfg.d_state + 2) + di

    if cfg.family in ("dense", "vlm"):
        n += cfg.n_layers * (attn_params() + mlp_params(cfg.d_ff))
    elif cfg.family == "moe":
        dense = cfg.n_dense_layers
        moe_layers = cfg.n_layers - dense
        n += cfg.n_layers * attn_params() + dense * mlp_params(cfg.d_ff)
        dffe = cfg.d_ff_expert or cfg.d_ff
        shared = cfg.n_shared_experts * mlp_params(dffe)
        routed = cfg.top_k if active_only else cfg.n_experts
        n += moe_layers * (shared + routed * mlp_params(dffe) + d * cfg.n_experts)
    elif cfg.family == "ssm":
        n += cfg.n_layers * ssm_params()
    elif cfg.family == "hybrid":
        n += cfg.n_layers * ssm_params()
        if cfg.attn_every:
            n += attn_params() + mlp_params(cfg.d_ff)  # ONE shared block
    elif cfg.family == "encdec":
        n += cfg.n_enc_layers * (attn_params() + mlp_params(cfg.d_ff))
        n += cfg.n_dec_layers * (2 * attn_params() + mlp_params(cfg.d_ff))
    n += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=4 if cfg.attn_every else max(2, min(3, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab=256,
        kv_lora=32 if cfg.mla else 0,
        q_lora=32 if cfg.q_lora else 0,
        rope_dims=8 if cfg.mla else cfg.rope_dims,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_dense_layers=min(cfg.n_dense_layers, 1),
        d_state=min(cfg.d_state, 8),
        ssm_heads=2 if cfg.ssm == "mamba2" else cfg.ssm_heads,
        attn_every=2 if cfg.attn_every else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_dec_layers=2 if cfg.n_dec_layers else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        frontend_len=4 if cfg.frontend else 0,
        frontend_dim=32 if cfg.frontend else 0,
    )
