"""The port's models, as far as the ported slices run them: the config
dataclasses, parameter tables, the dense SwiGLU FFN, and the sparse FFN
serving policy (dense path or the BSR kernel K5)."""

from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig, \
    smoke
from repro_torch.models.layers import dense, ffn, ffn_table
from repro_torch.models.params import Leaf, init_params, linear
from repro_torch.models.sparse_ffn import SparseFFN, SparseMatmul, \
    prune_blocks

__all__ = [
    "Leaf",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "SparseFFN",
    "SparseMatmul",
    "dense",
    "ffn",
    "ffn_table",
    "init_params",
    "linear",
    "prune_blocks",
    "smoke",
]
