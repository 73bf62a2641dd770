"""Architecture registry of the port: the configs ported so far (--arch <id>).

The JAX package's registry (``repro/configs``) holds ten; the port adds
each with the slice whose path runs it.  The four dense-family configs run
the model stack (``models.lm``) with its ``attn_ffn`` sub-layers; the MoE,
SSM, hybrid, VLM and encoder-decoder configs wait for the slice that ports
their sub-layer kinds.
"""

from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK
from repro_torch.configs.granite_20b import CONFIG as GRANITE
from repro_torch.configs.qwen2_0p5b import CONFIG as QWEN2
from repro_torch.configs.yi_34b import CONFIG as YI

ARCHS = {c.name: c for c in (GRANITE, YI, DEEPSEEK, QWEN2)}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return ARCHS[name]
