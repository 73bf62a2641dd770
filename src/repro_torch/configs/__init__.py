"""Architecture registry of the port: the ten configs (--arch <id>).

The JAX package's registry (``repro/configs``) holds the same ten; the
port added each with the slice whose path runs it.  The four dense configs run the
model stack (``models.lm``) with its ``attn_ffn`` sub-layers, the two MoE
configs add ``attn_moe`` (``models.moe``), the SSM config ``mamba``
(``models.ssm``) and the hybrid config ``mamba`` with the weight-tied
``shared_attn`` block, the VLM config (``llama-3.2-vision-90b``)
``attn_ffn_cross`` (gated cross-attention to the image embeddings every
``cross_attn_every`` layers) and the encoder-decoder config
(``seamless-m4t-large-v2``) ``enc_attn_ffn`` and ``dec_attn_cross_ffn``.
"""

from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA
from repro_torch.configs.granite_20b import CONFIG as GRANITE
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4
from repro_torch.configs.llama_3p2_vision_90b import CONFIG as LLAMA_VISION
from repro_torch.configs.qwen2_0p5b import CONFIG as QWEN2
from repro_torch.configs.qwen3_moe_30b import CONFIG as QWEN3_MOE
from repro_torch.configs.seamless_m4t_large import CONFIG as SEAMLESS
from repro_torch.configs.yi_34b import CONFIG as YI
from repro_torch.configs.zamba2_2p7b import CONFIG as ZAMBA2

ARCHS = {c.name: c for c in (GRANITE, YI, DEEPSEEK, QWEN2, QWEN3_MOE, LLAMA4,
                             FALCON_MAMBA, ZAMBA2, LLAMA_VISION, SEAMLESS)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return ARCHS[name]
