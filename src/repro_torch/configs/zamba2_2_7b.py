"""zamba2-2.7b — Mamba-2 backbone + ONE shared attention block applied every
6 layers.  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10_240,
    vocab=32_000,
    ssm="mamba2",
    d_state=64,
    d_conv=4,
    expand=2,
    ssm_heads=32,
    attn_every=6,
)
