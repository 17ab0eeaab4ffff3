"""gemma3-4b — dense, GQA, 5:1 local:global sliding window.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10_240,
    vocab=262_144,
    sliding_window=1024,
    global_every=6,  # layer (i+1) % 6 == 0 is global: 5 local : 1 global
    rope_theta=1_000_000.0,
)
