"""qwen3-1.7b — dense, GQA, qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
