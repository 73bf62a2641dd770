"""The port's models: the config dataclasses, parameter tables, layers,
the model stack (``blocks``, ``lm``) of every family (dense, MoE (``moe``),
SSM (``ssm``), hybrid, and the cross-attention families VLM and
encoder-decoder), and the sparse FFN (dense path, the BSR kernel K5, or the
spgemm path on the product stream)."""

from repro_torch.models.config import (
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, shapes_for, smoke,
)
from repro_torch.models.layers import dense, ffn, ffn_table
from repro_torch.models.lm import (
    abstract_model, backbone, decode_step, decode_step_loop, init_cache,
    init_model, model_specs, model_tables, prefill, train_loss,
)
from repro_torch.models.moe import moe_aux_loss, moe_dispatch_spgemm, \
    moe_ffn, moe_table
from repro_torch.models.params import Leaf, abstract_params, init_params, \
    linear, partition_specs
from repro_torch.models.sparse_ffn import SparseFFN, SparseMatmul, \
    densify_ffn_params, prune_blocks, sparsify_ffn_params
from repro_torch.models.ssm import mamba1_forward, mamba2_forward, \
    mamba_forward, mamba_init_state, mamba_table

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "TRAIN_4K",
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "shapes_for",
    "smoke", "abstract_model", "abstract_params", "backbone",
    "decode_step", "decode_step_loop", "init_cache", "init_model",
    "model_specs", "model_tables", "partition_specs", "prefill",
    "train_loss", "Leaf", "SparseFFN", "SparseMatmul", "dense", "densify_ffn_params",
    "ffn", "ffn_table", "init_params", "linear", "mamba1_forward",
    "mamba2_forward", "mamba_forward", "mamba_init_state", "mamba_table",
    "moe_aux_loss", "moe_dispatch_spgemm", "moe_ffn", "moe_table",
    "prune_blocks", "sparsify_ffn_params",
]
