"""qwen3-14b — dense, GQA, qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17_408,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
