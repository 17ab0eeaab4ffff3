"""qwen1.5-32b — dense, MHA (kv=40), QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27_392,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
