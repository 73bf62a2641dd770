"""zamba2-2.7b [hybrid]: Mamba2 backbone + one shared attention block applied
every 6 layers (weight-tied). [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_state=64, version=2, expand=2, head_dim=64, chunk=32),
    attn_every=6,
    rope_theta=10000.0,
    supports_long_context=True,   # hybrid: run long_500k
)
