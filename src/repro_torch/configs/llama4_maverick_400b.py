"""llama4-maverick-400b-a17b [moe]: alternating dense/MoE layers, 128 experts
top-1 + shared expert, early-fusion multimodal (frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,                       # dense (non-MoE) interleaved layers
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, interleave=2,
                  d_ff_shared=8192),
    rope_theta=500000.0,
)
