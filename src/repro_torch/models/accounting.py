"""Analytical parameter and FLOP accounting per (architecture x shape).

The port of the JAX package's ``repro/models/accounting.py``: host
arithmetic only, the same formulas in the same order.  MODEL_FLOPS follows
the assignment's convention: 6·N·D for training (N = active parameters, D
= tokens), 2·N·D for single-pass inference, plus the quadratic attention
term (not captured by N·D).  SSM scan work is elementwise and reported
separately.

The reference's TPU v5e constants (peak FLOP/s, HBM and ICI rates) are
left out: nothing here reads them.  A caller that needs a rate uses its own
card's (``chip_smoke.py`` holds the H100 SXM data sheet's).
"""

from __future__ import annotations

from repro_torch.models.blocks import block_structure
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.lm import abstract_model, model_tables
from repro_torch.models.params import abstract_params, partition_specs
from repro_torch.training.tree import tree_leaves


def total_params(cfg: ModelConfig) -> int:
    return sum(x.numel() for x in tree_leaves(abstract_model(cfg)))


def _attn_params(cfg) -> int:
    return cfg.d_model * (cfg.qkv_fused_q * 2 + cfg.qkv_fused_kv * 2)


def _ffn_params(cfg, d_ff) -> int:
    return 3 * cfg.d_model * d_ff


def _mamba_params(cfg) -> int:
    s = cfg.ssm
    din = cfg.d_inner
    if s.version == 1:
        dtr = cfg.dt_rank_actual
        return (cfg.d_model * 2 * din + s.d_conv * din
                + din * (dtr + 2 * s.d_state) + dtr * din
                + din * cfg.d_model)
    nh = din // s.head_dim
    return (cfg.d_model * (2 * din + 2 * s.d_state + nh) + s.d_conv * din
            + din * cfg.d_model)


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k experts + shared only)."""
    kinds, n_rep, _ = block_structure(cfg)
    per_block = 0
    for kind in kinds:
        if kind == "mamba":
            per_block += _mamba_params(cfg)
        elif kind == "attn_moe":
            m = cfg.moe
            per_block += _attn_params(cfg)
            per_block += m.top_k * 3 * cfg.d_model * m.d_ff_expert
            per_block += 3 * cfg.d_model * m.d_ff_shared
            per_block += cfg.d_model * m.n_experts  # router
        elif kind in ("attn_ffn", "enc_attn_ffn"):
            per_block += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        elif kind == "attn_ffn_cross":
            per_block += 2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        elif kind == "dec_attn_cross_ffn":
            per_block += 2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        elif kind == "shared_attn":
            per_block += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
    total = n_rep * per_block
    if cfg.family == "encdec":  # encoder runs once per sequence too
        total += cfg.n_encoder_layers * (
            _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
    total += cfg.d_model * cfg.vocab_padded  # unembed projection
    return total


def _n_attn_applications(cfg) -> int:
    """Causal self-attention applications per token (for the S^2 term)."""
    kinds, n_rep, _ = block_structure(cfg)
    per = sum(1 for k in kinds if k in (
        "attn_ffn", "attn_moe", "attn_ffn_cross", "dec_attn_cross_ffn",
        "shared_attn"))
    return n_rep * per


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Global MODEL_FLOPS for one step of this cell."""
    b, s = shape.global_batch, shape.seq_len
    n_act = active_params(cfg)
    n_attn = _n_attn_applications(cfg)
    hd = cfg.n_heads * cfg.d_head
    if shape.kind == "train":
        tokens = b * s
        linear = 6 * n_act * tokens
        attn = 3 * n_attn * 2 * b * s * s * hd  # fwd 2BS^2·H·Dh (qk+pv), x3
        return {"model_flops": linear + attn, "linear": linear,
                "attention": attn, "tokens": tokens, "n_active": n_act}
    if shape.kind == "prefill":
        tokens = b * s
        linear = 2 * n_act * tokens
        attn = n_attn * 2 * b * s * s * hd
        return {"model_flops": linear + attn, "linear": linear,
                "attention": attn, "tokens": tokens, "n_active": n_act}
    # decode: one token per slot against an S-long cache
    tokens = b
    linear = 2 * n_act * tokens
    attn = n_attn * 4 * b * s * cfg.n_kv_heads * cfg.d_head
    return {"model_flops": linear + attn, "linear": linear,
            "attention": attn, "tokens": tokens, "n_active": n_act}


def local_param_bytes(cfg: ModelConfig, axis_sizes: dict,
                      mode: str = "train", dtype_bytes: int = 2) -> float:
    """Exact per-device parameter bytes under the sharding rules."""
    dp = tuple(a for a in ("pod", "data") if a in axis_sizes)
    rules = {
        "__sizes__": axis_sizes,
        "embed": dp if mode == "train" else None,
        "vocab": "model", "mlp": "model", "heads": "model",
        "experts": "model" if mode == "train" else tuple(dp),
        "ssm_inner": "model", "layers": None, None: None,
    }
    table = model_tables(cfg)
    specs = tree_leaves(partition_specs(table, rules))
    abst = tree_leaves(abstract_params(table))
    total = 0.0
    for spec, leaf in zip(specs, abst):
        shards = 1
        for part in spec:
            if part is None:
                continue
            for a in (part if isinstance(part, tuple) else (part,)):
                shards *= axis_sizes[a]
        total += leaf.numel() * dtype_bytes / shards
    return total


def hbm_bytes_estimate(cfg: ModelConfig, shape: ShapeConfig,
                       n_devices: int, model_shards: int = 16,
                       accum: int = 1, w_local: float | None = None) -> float:
    """Per-device HBM traffic estimate (roofline memory term).

    Weights: each device reads its TP shard of every (all-gathered) weight
    per microbatch pass (fwd + bwd + remat-fwd for train).  Optimizer: read
    + write moments and params once per step.  Activations: ~16 bytes/
    token/d_model/layer rule of thumb (bf16 residual + block internals
    after remat).  KV cache: full local shard read per decoded token.
    """
    n_total = total_params(cfg)
    if w_local is None:
        w_local = 2 * n_total / model_shards  # bf16 weight bytes, fallback
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        passes = 3 * accum            # fwd + remat fwd + bwd
        opt = 3 * (n_total / n_devices) * (2 + 1 + 1 + 8)  # p,m8,v8,scales
        tokens_local = b * s / max(n_devices / model_shards, 1)
        act = 16 * tokens_local * cfg.d_model * cfg.n_layers / model_shards
        return w_local * passes + opt + act
    if shape.kind == "prefill":
        tokens_local = b * s / max(n_devices / model_shards, 1)
        act = 8 * tokens_local * cfg.d_model * cfg.n_layers / model_shards
        return w_local + act
    # decode
    n_attn = _n_attn_applications(cfg)
    kv_global = 2 * n_attn * b * s * cfg.n_kv_heads * cfg.d_head * 2
    kv_local = kv_global / n_devices
    return w_local + kv_local
