"""phi3.5-moe-42b-a6.6b — 16 experts, top-2 routing, GQA.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab=32_064,
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
)
