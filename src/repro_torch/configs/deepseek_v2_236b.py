"""deepseek-v2-236b — MLA (kv_lora=512) + 160 routed experts top-6 + 2 shared.
First layer dense FFN.  [arXiv:2405.04434; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12_288,        # dense first-layer FFN
    vocab=102_400,
    mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_dims=64,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1536,
    n_dense_layers=1,
)
