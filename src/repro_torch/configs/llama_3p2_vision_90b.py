"""llama-3.2-vision-90b [vlm]: 100L backbone, gated cross-attention image
layers every 5; the vision frontend is a STUB — input_specs() provides
pre-projected patch embeddings [B, n_image_tokens, d_model].
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_image_tokens=1601,
    rope_theta=500000.0,
)
