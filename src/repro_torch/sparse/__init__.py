"""Sparse-matrix substrate of the PyTorch port: formats, generators, statistics.

Structure and planning stay host numpy (as in the JAX package); values and
kernel results are torch tensors on the device the caller chose.
"""

from repro_torch.sparse.format import (
    COO,
    CSC,
    CSR,
    BatchedCSC,
    BatchedCSCBuilder,
    CSCBuilder,
    ColumnSlots,
    csc_bit_identical,
    csc_equal,
    csc_from_coo,
    csc_from_dense,
    csc_from_numpy,
    csc_pad_gather,
    csc_to_csr,
    csc_to_dense,
    csc_to_padded_columns,
    csr_to_csc,
    padded_values,
    padded_values_batched,
    segment_reduce,
    transpose_csc,
    validate_csc,
)
from repro_torch.sparse.generate import (
    random_banded_csc,
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
    load_or_synthesize,
    synthesize_suitesparse,
)

__all__ = [
    "COO",
    "CSC",
    "CSR",
    "BatchedCSC",
    "BatchedCSCBuilder",
    "CSCBuilder",
    "ColumnSlots",
    "csc_bit_identical",
    "csc_equal",
    "csc_from_coo",
    "csc_from_dense",
    "csc_from_numpy",
    "csc_pad_gather",
    "csc_to_csr",
    "csc_to_dense",
    "csc_to_padded_columns",
    "csr_to_csc",
    "padded_values",
    "padded_values_batched",
    "segment_reduce",
    "transpose_csc",
    "validate_csc",
    "random_banded_csc",
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
    "load_or_synthesize",
    "synthesize_suitesparse",
]
