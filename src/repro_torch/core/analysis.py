"""Pre-processing analysis: the paper's sorting, blocking and sizing machinery.

Everything here is host-side numpy, copied from the JAX package as it is (the
paper also performs these as scalar pre-processing, excluded from its timed
region but reported).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.format import CSC
from repro_torch.sparse.stats import ops_per_column

# paper's platform: 8 lanes, max vector length 256 doubles
VL_MAX = 256
N_LANES = 8

# multiplicative hash constant (odd => bijective mod powers of two); the paper
# uses h(i) = (i*c) mod H without fixing c.
HASH_C = 2654435761  # Knuth's multiplicative constant


def sort_columns(ops: np.ndarray) -> np.ndarray:
    """Permutation P with ops[P] non-increasing (stable; paper Section 3.1).

    The matrix is never physically reordered; algorithms access B's columns
    through P and the result is C·P, undone by the caller via P.
    """
    # stable sort on negated ops keeps equal-load columns in original order,
    # which keeps blocks contiguous-ish in the original matrix
    return np.argsort(-ops, kind="stable")


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Output of the blocking algorithm over *sorted* columns.

    starts[i], sizes[i]: block i covers sorted-column positions
    [starts[i], starts[i] + sizes[i]).  ``sizes[i]`` is the vector length used
    to process block i.
    """

    starts: np.ndarray
    sizes: np.ndarray

    @property
    def n_blocks(self) -> int:
        return len(self.starts)

    def __iter__(self):
        return zip(self.starts.tolist(), self.sizes.tolist())


def blocking_schedule(
    ops_sorted: np.ndarray, b_min: int, b_max: int, start: int = 0
) -> BlockSchedule:
    """The paper's blocking algorithm (Section 3.1) over sorted loads.

    From position j: take b_min columns; while the next column's Op equals the
    block's max (= the first column's, since sorted), grow; stop at b_max or
    the end. ``start`` lets hybrids begin blocking at the SPA/SPARS switch.
    """
    if b_min < 1 or b_max < b_min:
        raise ValueError(f"invalid block bounds ({b_min}, {b_max})")
    n = len(ops_sorted)
    starts, sizes = [], []
    j = start
    while j < n:
        j2 = min(j + b_min, n)
        head = ops_sorted[j]
        while j2 < min(j + b_max, n) and ops_sorted[j2] == head:
            j2 += 1
        starts.append(j)
        sizes.append(j2 - j)
        j = j2
    return BlockSchedule(np.asarray(starts, np.int64), np.asarray(sizes, np.int64))


def hash_table_size(max_ops: int) -> int:
    """H = 2^k with 2^(k-1) <= max_ops < 2^k  (Section 3.2); minimum 2.

    max_ops bounds the number of intermediate products of any column in the
    block, hence the occupancy of its hash table.
    """
    if max_ops <= 1:
        return 2
    return 1 << int(np.ceil(np.log2(max_ops + 1e-12)))


def hybrid_split(ops_sorted: np.ndarray, t: float) -> int:
    """First sorted position processed by the blocked algorithm.

    H-SPA(t)/H-HASH(t): columns with Op_j >= t go to SPA; the tail (Op_j < t)
    goes to SPARS/HASH. t=0 => all SPA; t=inf => all blocked.
    """
    if t <= 0:
        return len(ops_sorted)
    if np.isinf(t):
        return 0
    return int(np.searchsorted(-ops_sorted, -t, side="right"))


@dataclasses.dataclass(frozen=True)
class Preprocess:
    """Everything the paper's pre-processing phase produces."""

    ops: np.ndarray          # Op_j in original column order
    perm: np.ndarray         # sorted-position -> original column
    ops_sorted: np.ndarray   # ops[perm]
    split: int               # SPA | blocked boundary (sorted position)
    blocks: BlockSchedule    # blocks over [split, n)
    hash_sizes: np.ndarray   # per-block H (power of two), for HASH only

    @property
    def n_cols(self) -> int:
        return len(self.ops)


def preprocess(
    a: CSC,
    b: CSC,
    *,
    t: float = np.inf,
    b_min: int = VL_MAX,
    b_max: int = VL_MAX,
    sort: bool = True,
) -> Preprocess:
    ops = ops_per_column(a, b)
    perm = sort_columns(ops) if sort else np.arange(len(ops))
    ops_sorted = ops[perm]
    split = hybrid_split(ops_sorted, t)
    blocks = blocking_schedule(ops_sorted, b_min, b_max, start=split)
    hs = np.asarray(
        [hash_table_size(int(ops_sorted[s])) if z > 0 else 2 for s, z in blocks],
        np.int64,
    )
    # Section 3.2: H never grows back while walking sorted blocks; enforce the
    # monotone shrink the paper describes (start from the first block's size).
    for i in range(1, len(hs)):
        hs[i] = min(hs[i], hs[i - 1])
    return Preprocess(ops, perm, ops_sorted, split, blocks, hs)
