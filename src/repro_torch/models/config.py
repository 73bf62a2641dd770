"""Model + input-shape configuration dataclasses, copied from the JAX
package's ``repro/models/config.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    interleave: int = 1        # 1 = every layer MoE; 2 = alternate dense/MoE
    capacity_factor: float = 1.25
    d_ff_shared: int = 0       # shared-expert FFN width (0 = none)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    version: int = 1           # 1 = Mamba1 (selective scan), 2 = Mamba2 (SSD)
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64         # Mamba2 only
    dt_rank: int = 0           # Mamba1; 0 => ceil(d_model/16)
    chunk: int = 64            # scan chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): one *shared* attention block applied every k
    attn_every: int = 0
    # vlm (llama-3.2-V-style): cross-attention layer every k
    cross_attn_every: int = 0
    n_image_tokens: int = 1601
    # encdec (seamless-style)
    n_encoder_layers: int = 0
    n_audio_frames: int = 4096

    # execution
    scan_layers: bool = True
    remat: str = "full"        # full | dots | none
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    logits_chunk: int = 512

    # which serve shapes apply (DESIGN.md §4)
    supports_long_context: bool = False   # sub-quadratic archs only
    has_decoder: bool = True

    @property
    def qkv_fused_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def qkv_fused_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 512) * 512

    @property
    def dt_rank_actual(self) -> int:
        if self.ssm and self.ssm.dt_rank:
            return self.ssm.dt_rank
        return -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand if self.ssm else 2) * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig):
    """The assignment's applicability rules (DESIGN.md §4)."""
    out = [TRAIN_4K, PREFILL_32K]
    if cfg.has_decoder:
        out.append(DECODE_32K)
        if cfg.supports_long_context:
            out.append(LONG_500K)
    return tuple(out)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256,
        d_head=32,
        vocab=512,
        attn_q_chunk=64,
        attn_kv_chunk=64,
        logits_chunk=64,
        scan_layers=cfg.scan_layers,
        n_image_tokens=24,
        n_audio_frames=32,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.d_ff_shared else 0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk=16)
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["n_layers"] = 4
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_layers"] = 4
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["n_layers"] = 2
    if cfg.moe and cfg.moe.interleave > 1:
        kw["n_layers"] = 4
    return dataclasses.replace(cfg, **kw)
