"""falcon-mamba-7b — attention-free Mamba-1 SSM.  [arXiv:2410.05355; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=65_024,
    ssm="mamba1",
    d_state=16,
    d_conv=4,
    expand=2,
)
