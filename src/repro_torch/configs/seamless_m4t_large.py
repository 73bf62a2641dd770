"""seamless-m4t-large-v2 [audio]: encoder-decoder; the speech frontend is a
STUB — input_specs() provides precomputed frame embeddings
[B, n_audio_frames, d_model]. [arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                     # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,                    # padded to 256512 internally
    n_audio_frames=4096,
    rope_theta=10000.0,
)
