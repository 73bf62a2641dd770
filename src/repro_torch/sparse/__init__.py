"""Sparse-matrix substrate of the PyTorch port: formats, generators, statistics.

Structure and planning stay host numpy (as in the JAX package); values and
kernel results are torch tensors on the device the caller chose.
"""

from repro_torch.sparse.format import (
    CSC,
    CSCBuilder,
    ColumnSlots,
    csc_equal,
    csc_from_dense,
    csc_from_numpy,
    csc_pad_gather,
    csc_to_dense,
    csc_to_padded_columns,
    padded_values,
    validate_csc,
)
from repro_torch.sparse.generate import (
    random_density_csc,
    random_powerlaw_csc,
    random_uniform_csc,
)
from repro_torch.sparse.stats import (
    MatrixStats,
    column_nnz,
    matrix_stats,
    ops_per_column,
    steps_per_column,
)
from repro_torch.sparse.suitesparse import (
    SUITESPARSE_TABLE1,
    MatrixSpec,
    by_name,
    synthesize_suitesparse,
)

__all__ = [
    "CSC",
    "CSCBuilder",
    "ColumnSlots",
    "csc_equal",
    "csc_from_dense",
    "csc_from_numpy",
    "csc_pad_gather",
    "csc_to_dense",
    "csc_to_padded_columns",
    "padded_values",
    "validate_csc",
    "random_density_csc",
    "random_powerlaw_csc",
    "random_uniform_csc",
    "MatrixStats",
    "column_nnz",
    "matrix_stats",
    "ops_per_column",
    "steps_per_column",
    "SUITESPARSE_TABLE1",
    "MatrixSpec",
    "by_name",
    "synthesize_suitesparse",
]
