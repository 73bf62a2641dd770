"""falcon-mamba-7b [ssm]: pure Mamba1, attention-free.
[arXiv:2410.05355; unverified]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                       # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(d_state=16, version=1, expand=2, chunk=64),
    supports_long_context=True,      # SSM: run long_500k
)
