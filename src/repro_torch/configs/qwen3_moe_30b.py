"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, every layer MoE, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, interleave=1),
    rope_theta=1000000.0,
)
