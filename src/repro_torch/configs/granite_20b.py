"""granite-20b [dense]: llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=10000.0,
)
