"""Symbolic SpGEMM planning: analyze a sparsity pattern once, execute often.

``plan_spgemm`` runs every pattern-dependent step once — Op_j analysis,
column sorting, blocking, hash-table sizing, padded kernel layouts,
per-family column groups, per-block trip counts — on the host in numpy, and
captures the result in an immutable :class:`SpgemmPlan` whose index arrays
live on the plan's device.  Executing the plan (``core.executor``) does
only value work: one gather per operand and one kernel launch per group, or,
under ``engine="fused"``, one K1 launch over the plan's product stream
(``core.fast``, built at first use).

Plans are keyed by :func:`pattern_fingerprint`, which hashes only structure
(shape, col_ptr, row_indices) — never values — so ``core.api``'s bounded LRU
can reuse plans across calls with identical patterns.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backends, fast
from repro_torch.core.analysis import Preprocess, preprocess
from repro_torch.core.fast import ProductStream, build_product_stream
from repro_torch.device import resolve_device
from repro_torch.sparse.format import CSC, ColumnSlots, _np, csc_pad_gather
from repro_torch.sparse.stats import ops_per_column, steps_per_column

# method -> base kwargs; the paper's Section 5.3 configurations that have a
# kernel family (the JAX package's host-only "esc" and "expand" have none)
ALGORITHMS = {
    "spa": {},
    "spars-16/64": dict(b_min=16, b_max=64),
    "spars-40/40": dict(b_min=40, b_max=40),
    "h-spa-16/64": dict(t=40, b_min=16, b_max=64, accumulator="spa"),
    "h-spa-40/40": dict(t=40, b_min=40, b_max=40, accumulator="spa"),
    "hash-32/256": dict(b_min=32, b_max=256),
    "hash-256/256": dict(b_min=256, b_max=256),
    "h-hash-32/256": dict(t=40, b_min=32, b_max=256, accumulator="hash"),
    "h-hash-256/256": dict(t=40, b_min=256, b_max=256, accumulator="hash"),
}

#: lane-block width of the lock-step kernels, and C columns per launch
BLOCK_COLS = 128


def resolve_params(method: str) -> dict:
    """The named method's parameters; raises on a method with no kernel
    family."""
    if method not in ALGORITHMS:
        raise ValueError(
            f"unknown method {method!r}; one of {list(ALGORITHMS)}")
    return dict(ALGORITHMS[method])


def pattern_fingerprint(m: CSC) -> str:
    """Hash of the sparsity pattern only (shape + col_ptr + row_indices)."""
    cp = _np(m.col_ptr)
    ri = _np(m.row_indices)[: int(cp[-1])]
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{tuple(m.shape)}:{cp.dtype}:{ri.dtype}".encode())
    h.update(cp.tobytes())
    h.update(ri.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Pattern:
    """Value-free view of one CSC operand: host structure + fingerprint."""

    row_indices: np.ndarray
    col_ptr: np.ndarray
    shape: Tuple[int, int]
    fingerprint: str

    @classmethod
    def of(cls, m: CSC) -> "Pattern":
        cp = _np(m.col_ptr)
        return cls(
            np.ascontiguousarray(_np(m.row_indices)[: int(cp[-1])], np.int32),
            np.ascontiguousarray(cp, np.int32),
            tuple(m.shape),
            pattern_fingerprint(m),
        )

    @property
    def nnz(self) -> int:
        return int(self.col_ptr[-1])

    def check_compatible(self, operand) -> None:
        """O(1) check of an execute-time operand (shape and nnz for a CSC,
        length for a raw value vector)."""
        if isinstance(operand, CSC):
            if tuple(operand.shape) != self.shape:
                raise ValueError(
                    f"operand shape {tuple(operand.shape)} != planned "
                    f"{self.shape}")
            if operand.nnz != self.nnz:
                raise ValueError(
                    f"operand nnz {operand.nnz} != planned {self.nnz} "
                    "(sparsity pattern does not match this plan)")
            return
        shape = tuple(operand.shape)
        if len(shape) != 1:
            raise ValueError(f"expected a 1-D value array, got shape {shape}")
        if shape[0] < self.nnz:
            raise ValueError(f"need >= {self.nnz} values, got {shape[0]}")


@dataclasses.dataclass(frozen=True)
class KernelGroup:
    """One kernel launch of the per-group execution schedule.

    ``cols`` are the original B/C column ids this launch computes, in lane
    order (pad lanes point at column 0 with nnz forced to 0); ``cols_t`` is
    the same on the plan's device, for compaction.  ``b_rows``/``b_nnz``/
    ``steps`` are the pattern-static halves of the padded group operand,
    and the group's padded value operand is
    ``where(b_vmask, values[b_vgather], 0)``: one gather from the raw B
    values per launch, all index tensors resident on the plan's device.
    """

    kind: str                      # "spa" | "spars" | "hash"
    cols: np.ndarray               # [n_real] original column ids (host)
    cols_t: torch.Tensor           # [n_real] int64 (device)
    b_rows: torch.Tensor           # [n_pad, zb] int32 (device)
    b_nnz: torch.Tensor            # [n_pad] int32 (device)
    b_vgather: torch.Tensor        # [n_pad, zb] int64 into B's raw values
    b_vmask: torch.Tensor          # [n_pad, zb] bool, False for pads
    steps: Optional[torch.Tensor] = None  # [n_pad/block_cols] int32
    h: Optional[int] = None               # hash-table size (kind == "hash")

    @property
    def n_real(self) -> int:
        return len(self.cols)


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """The padded operand layout and launch groups of one plan (the
    counterpart of the JAX package's ``PallasLayout``).

    The A operand rides whole into every launch; B is pre-sliced per group.
    ``a_gather``/``a_mask`` re-pad fresh A values with one gather.
    ``c_slots`` bounds each C column's entries by min(Op_j, m), so each
    group's output is compacted on the device with no host sync.
    """

    a_rows: torch.Tensor      # [n_a, za] int32 (device)
    a_nnz: torch.Tensor       # [n_a] int32 (device)
    a_gather: torch.Tensor    # [n_a, za] int64 (device)
    a_mask: torch.Tensor      # [n_a, za] bool (device)
    c_slots: ColumnSlots
    groups: Tuple[KernelGroup, ...]


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Immutable symbolic plan for C = A @ B with one algorithm, on one
    device.  Execute with ``plan.execute(a_values, b_values)`` (CSC operands
    or raw value vectors aligned with the planned patterns)."""

    method: str
    backend: str
    params: tuple             # sorted (key, value) pairs, hashable
    a: Pattern
    b: Pattern
    pre: Optional[Preprocess]
    layout: KernelLayout
    device: torch.device
    stream_limit: Optional[int] = None  # plan-memory guard (products)
    _stream_memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.a.shape[0], self.b.shape[1])

    @property
    def stream(self) -> Optional[ProductStream]:
        """The product stream of the fused engine (``core.fast``), built at
        first access and kept on the plan, so per-group executions never
        pay for it.  ``None`` when it would exceed ``stream_limit``."""
        if "stream" not in self._stream_memo:
            self._stream_memo["stream"] = build_product_stream(
                self.a, self.b, self.stream_limit)
        return self._stream_memo["stream"]

    @property
    def stream_nbytes(self) -> int:
        """Host bytes of the stream this plan holds (0 before the first
        fused execution and when the guard tripped); reads the memo
        without building it."""
        s = self._stream_memo.get("stream")
        return s.nbytes if s is not None else 0

    @property
    def fused_stream_nbytes(self) -> int:
        """Device bytes of the K1 views this plan holds
        (``core.fused_stream``); reads the memo without building them."""
        f = self._stream_memo.get("fused")
        return f.nbytes if f is not None else 0

    def stream_apply(self, a_values, b_values, engine: str | None = None):
        """Differentiable numeric phase: C's values only.

        ``a_values``/``b_values`` are value vectors (torch tensors, which
        may require grad) aligned with the planned patterns; the result is
        the ``[nnz_c]`` f32 value vector of C on the stream's structure
        (``plan.stream.c_rows``/``c_col_ptr``), on the plan's device, and
        ``torch.autograd`` differentiates it with two more K1 replays.
        Only ``engine="fused"`` exists: the JAX package's XLA device stream
        (``engine=None``/``"stream"``) has no counterpart in the port yet.
        A guarded plan raises (there is no stream to differentiate through).
        """
        if engine != "fused":
            raise ValueError(
                f"stream_apply supports only engine='fused' in this port, "
                f"got {engine!r}: the XLA device stream (engine=None/"
                "'stream') is not ported")
        from repro_torch.core.fused_stream import fused_fn

        self.a.check_compatible(a_values)
        self.b.check_compatible(b_values)
        return fused_fn(self)(a_values, b_values)

    def execute(self, a_values, b_values, *, stats: dict | None = None,
                engine: str | None = None) -> CSC:
        """Numeric phase only: C for new values on the planned patterns."""
        from repro_torch.core.executor import execute

        return execute(self, a_values, b_values, stats=stats, engine=engine)


def plan_spgemm(
    a: CSC,
    b: CSC,
    method: str = "h-hash-256/256",
    *,
    backend: str = "cuda",
    device=None,
    stream_limit: int | None = None,
) -> SpgemmPlan:
    """Build the symbolic plan for C = A @ B (pattern-dependent work only).

    ``device`` (default ``"cuda"``) is where the plan's index tensors live
    and its kernels run.  Every launch covers at most ``BLOCK_COLS`` C
    columns, one lane block of the lock-step kernels.  The fused engine's
    product stream is kept on the plan while it has at most
    ``stream_limit`` products (default ``fast.STREAM_MAX_PRODUCTS``);
    above that each fused execution rebuilds it and keeps nothing.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    params = resolve_params(method)
    backends.get_backend(backend)   # canonical unknown-backend error
    dev = resolve_device(device)
    pre, layout = _plan_groups(a, b, method, params, dev)
    limit = (fast.STREAM_MAX_PRODUCTS if stream_limit is None
             else int(stream_limit))
    return SpgemmPlan(method, backend, tuple(sorted(params.items())),
                      Pattern.of(a), Pattern.of(b), pre, layout, dev, limit)


def _plan_groups(a, b, method, params, dev):
    """The per-group launch schedule (mirrors the JAX package's
    ``_plan_pallas`` at its default ``block_cols = tile_cols = 128``),
    built in numpy and lifted once to ``dev``."""
    n = b.n_cols
    a_rows, a_gather, a_mask, a_nnz = csc_pad_gather(a)
    b_rows, b_gather, b_mask, b_nnz = csc_pad_gather(b)

    def lift(x):
        return torch.as_tensor(x, device=dev)

    groups: list[KernelGroup] = []

    def add_group(kind, cols, steps=None, h=None):
        cols = np.asarray(cols, np.int64)
        n_real = len(cols)
        n_pad = BLOCK_COLS
        sel = np.zeros(n_pad, np.int64)
        sel[:n_real] = cols
        valid = np.zeros(n_pad, bool)
        valid[:n_real] = True
        g_rows = np.where(valid[:, None], b_rows[sel], 0).astype(np.int32)
        g_nnz = np.where(valid, b_nnz[sel], 0).astype(np.int32)
        if steps is not None:
            steps = lift(np.asarray([steps], np.int32))
        groups.append(KernelGroup(
            kind, cols, lift(cols), lift(g_rows), lift(g_nnz),
            lift(b_gather[sel]), lift(b_mask[sel] & valid[:, None]),
            steps, h))

    if method == "spa":
        pre = None
        head = np.arange(n)
    else:
        tt = params["t"] if method.startswith("h-") else np.inf
        # the lock-step kernels use fixed-width lane blocks: the blocking
        # bounds collapse to BLOCK_COLS (the named method only selects the
        # family), exactly as in the JAX package
        pre = preprocess(a, b, t=tt, b_min=BLOCK_COLS, b_max=BLOCK_COLS)
        head = pre.perm[: pre.split]

    # the kernels process each lane independently, so one launch per
    # BLOCK_COLS columns changes peak memory, never values
    for c0 in range(0, len(head), BLOCK_COLS):
        add_group("spa", head[c0: c0 + BLOCK_COLS])

    if method != "spa" and pre.blocks.n_blocks:
        fam = "hash" if "hash" in method else "spars"
        starts, sizes = pre.blocks.starts, pre.blocks.sizes
        # per-block trip count: the block max of steps_per_column (a lane
        # takes one step per stored B entry even on an empty A column)
        steps_sorted = steps_per_column(a, b)[pre.perm]
        steps_all = np.maximum.reduceat(steps_sorted, starts).astype(np.int32)
        for i in range(pre.blocks.n_blocks):
            # H shrinks monotonically along sorted blocks (Section 3.2):
            # one launch per block, each with its block's table size
            lo = int(starts[i])
            add_group(fam, pre.perm[lo: lo + int(sizes[i])],
                      steps=steps_all[i],
                      h=int(pre.hash_sizes[i]) if fam == "hash" else None)

    # C column j holds at most min(Op_j, m) entries: the compaction's slots
    ops = ops_per_column(a, b) if pre is None else pre.ops
    cap = np.minimum(ops, a.n_rows)
    tile_cells = max(((a.n_rows if g.h is None else g.h) * g.n_real
                      for g in groups), default=0)
    layout = KernelLayout(
        a_rows=lift(a_rows),
        a_nnz=lift(a_nnz.astype(np.int32)),
        a_gather=lift(a_gather),
        a_mask=lift(a_mask),
        c_slots=ColumnSlots.of(cap, tile_cells, dev),
        groups=tuple(groups),
    )
    return pre, layout
