"""seamless-m4t-medium — encoder-decoder audio backbone; the modality
frontend is a STUB (precomputed frame embeddings).  [arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,        # 12 enc + 12 dec
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=256_206,
    frontend="frames",
    frontend_dim=160,   # stub fbank-embedding width
    frontend_len=1024,  # default encoder frames (overridden by shape)
)
