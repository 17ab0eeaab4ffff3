"""internvl2-2b — InternLM2 LM backbone; InternViT frontend is a STUB
(precomputed patch embeddings).  [arXiv:2404.16821; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92_553,
    frontend="patches",
    frontend_dim=1024,  # stub InternViT embedding width
    frontend_len=256,   # patches per image
)
