"""Symbolic SpGEMM planning: analyze a sparsity pattern once, execute often.

``plan_spgemm`` runs every pattern-dependent step once, on the host in
numpy, and captures the result in an immutable :class:`SpgemmPlan`:

- a ``"cuda"`` plan holds the per-group launch schedule — Op_j analysis,
  column sorting, blocking, hash-table sizing, padded kernel layouts,
  per-family column groups, per-block trip counts — with its index arrays
  on the plan's device;
- a ``"host"`` plan holds the patterns and, for the blocked methods, the
  paper's pre-processing that its naive oracles consume;
- a ``"torch"`` plan holds the patterns alone: its numeric phase is the
  method-independent stream contraction, so every method spelling plans as
  the canonical ``"expand"``.

Every plan builds its product stream (``core.fast``) at first use, and the
device engines lift it to the plan's device once (``core.device_stream``,
``core.fused_stream``).  Executing a plan (``core.executor``) does only
value work.

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

from repro_torch.core import backends, fast, faults
from repro_torch.core.analysis import Preprocess, preprocess
from repro_torch.core.cost import CostConstants, check_candidates, \
    choose_method
from repro_torch.core.fast import ProductStream, build_product_stream
from repro_torch.device import resolve_device
from repro_torch.sparse.format import CSC, BatchedCSC, ColumnSlots, _np, \
    as_tensor, csc_pad_gather
from repro_torch.sparse.partition import auto_tile_grid, csc_col_slice, \
    csc_row_slice, nnz_balanced_col_bounds, width_col_bounds
from repro_torch.sparse.stats import ops_per_column, steps_per_column, \
    tile_stats

# method -> base kwargs; the paper's Section 5.3 configurations, and the
# host-only executors (no kernel family on the cuda backend)
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
    "esc": {},
    "expand": {},  # the host expansion executor (not a paper algorithm)
}

#: the prefixes of the method families whose bounds may be spelled out in
#: an unregistered name (``spars-128/128``)
FAMILY_PREFIXES = ("spars", "hash", "h-")

#: the default lane-block width of the lock-step kernels, and of C columns
#: per launch (``plan_spgemm``'s ``block_cols``)
BLOCK_COLS = 128


def resolve_params(
    method: str,
    *,
    t: float | None = None,
    b_min: int | None = None,
    b_max: int | None = None,
) -> dict:
    """The named method's parameters, with the given overrides.

    An unregistered ``family-x/y`` name (``spars-128/128``) takes its block
    bounds from the name itself, as in the JAX package.
    """
    params = dict(ALGORITHMS.get(method, ()))
    if method not in ALGORITHMS:
        if "-" in method:
            bounds = method.rsplit("-", 1)[1]
            # a trailing all-digit or x/y token is a bounds spec and must
            # parse; anything else (a bare family prefix) is not
            if "/" in bounds or bounds.isdigit():
                try:
                    bmin, bmax = (int(x) for x in bounds.split("/"))
                except ValueError:
                    raise ValueError(
                        f"malformed block bounds in method {method!r}; "
                        "expected 'family-bmin/bmax'") from None
                params.setdefault("b_min", bmin)
                params.setdefault("b_max", bmax)
        if method.startswith("h-"):
            params.setdefault("t", 40.0)
            params.setdefault(
                "accumulator", "hash" if "hash" in method else "spa")
    if method.startswith(FAMILY_PREFIXES):
        params.setdefault("b_min", 256)
        params.setdefault("b_max", 256)
    if t is not None:
        params["t"] = t
    if b_min is not None:
        params["b_min"] = b_min
    if b_max is not None:
        params["b_max"] = b_max
    return params


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

    def _check_structure(self, operand, validate) -> None:
        """Shape and nnz of a CSC or BatchedCSC operand (O(1)), and with
        ``validate="fingerprint"`` its whole structure (O(nnz))."""
        if tuple(operand.shape) != self.shape:
            raise ValueError(
                f"operand shape {tuple(operand.shape)} != planned "
                f"{self.shape}")
        if operand.nnz != self.nnz:
            raise ValueError(
                f"operand nnz {operand.nnz} != planned {self.nnz} "
                "(sparsity pattern does not match this plan)")
        if (validate == "fingerprint"
                and pattern_fingerprint(operand) != self.fingerprint):
            raise ValueError(
                "operand sparsity pattern does not match this plan "
                "(fingerprint mismatch despite equal shape and nnz)")

    def check_compatible(self, operand, validate: str | None = None) -> None:
        """Check an execute-time operand: shape and nnz for a CSC, length
        for a raw value vector (O(1)).

        A same-shape same-nnz CSC with another pattern passes the default
        check; ``validate="fingerprint"`` re-hashes its structure and
        rejects it.  Raw value vectors carry no structure, so the
        fingerprint check has nothing to read there.
        """
        _check_validate(validate)
        if isinstance(operand, CSC):
            self._check_structure(operand, validate)
            return
        shape = tuple(operand.shape)
        if len(shape) != 1:
            raise ValueError(
                f"expected a 1-D value array, got shape {shape} "
                "(use execute_batched for [B, nnz] value stacks)")
        if shape[0] < self.nnz:
            raise ValueError(f"need >= {self.nnz} values, got {shape[0]}")

    def check_batched_compatible(self, operand,
                                 validate: str | None = None) -> None:
        """Batched twin of :meth:`check_compatible`: shape and nnz for a
        :class:`BatchedCSC`, ``[B, >= nnz]`` for a raw value stack.  A
        single CSC or a 1-D array is rejected (use ``execute``)."""
        _check_validate(validate)
        if isinstance(operand, BatchedCSC):
            self._check_structure(operand, validate)
            return
        # a CSC's shape is (n_rows, n_cols): never read it as [B, nnz]
        shape = None if isinstance(operand, CSC) else np.shape(operand)
        if shape is None or len(shape) != 2:
            raise ValueError(
                "batched operand must be a BatchedCSC or a [B, nnz] value "
                f"array, got {'a CSC' if shape is None else tuple(shape)}")
        if shape[1] < self.nnz:
            raise ValueError(f"need >= {self.nnz} values per batch element, "
                             f"got {shape[1]}")

    def batched_values(self, operand,
                       validate: str | None = None) -> torch.Tensor:
        """The ``[B, nnz]`` value stack (torch, where it lies) of a batched
        execute-time operand: a :class:`BatchedCSC` with this pattern or a
        raw ``[B, >= nnz]`` stack."""
        self.check_batched_compatible(operand, validate)
        v = operand.values if isinstance(operand, BatchedCSC) else operand
        return as_tensor(v)[:, : self.nnz]

    def with_values(self, values, validate: str | None = None) -> CSC:
        """This pattern with numeric values bound (a CSC or a raw vector)."""
        self.check_compatible(values, validate)
        v = values.values if isinstance(values, CSC) else values
        return CSC(as_tensor(v), self.row_indices, self.col_ptr, self.shape)


def _check_validate(validate) -> None:
    if validate not in (None, "fingerprint"):
        raise ValueError(
            f"unknown validate mode {validate!r}; None or 'fingerprint'")


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

    block_cols: int           # lane-block width of the lock-step kernels
    tile_cols: int            # most C columns one launch computes
    a_rows: torch.Tensor      # [n_a, za] int32 (device)
    a_nnz: torch.Tensor       # [n_a] int32 (device)
    a_gather: torch.Tensor    # [n_a, za] int64 (device)
    a_mask: torch.Tensor      # [n_a, za] bool (device)
    c_slots: ColumnSlots
    groups: Tuple[KernelGroup, ...]


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Immutable symbolic plan for C = A @ B with one algorithm and backend,
    on one device.  Execute with ``plan.execute(a_values, b_values)`` (CSC
    operands or raw value vectors aligned with the planned patterns)."""

    method: str
    backend: str
    params: tuple             # sorted (key, value) pairs, hashable
    a: Pattern
    b: Pattern
    pre: Optional[Preprocess]        # the paper's pre-processing, if used
    layout: Optional[KernelLayout]   # the launch schedule ("cuda" plans)
    device: torch.device
    stream_limit: Optional[int] = None  # plan-memory guard (products)
    _stream_memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def contract(self) -> "backends.ExecutionContract":
        """This plan's backend contract (``core.backends``)."""
        return backends.get_backend(self.backend)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.a.shape[0], self.b.shape[1])

    @property
    def stream(self) -> Optional[ProductStream]:
        """The product stream of the stream engines (``core.fast``), built at
        first access and kept on the plan, so per-group executions never
        pay for it.  ``None`` when it would exceed ``stream_limit``."""
        if "stream" not in self._stream_memo:
            self._stream_memo["stream"] = build_product_stream(
                self.a, self.b, self.stream_limit)
        return self._stream_memo["stream"]

    @property
    def stream_nbytes(self) -> int:
        """Host bytes of the stream this plan holds (0 before the first
        stream execution and when the guard tripped); reads the memo
        without building it."""
        s = self._stream_memo.get("stream")
        return s.nbytes if s is not None else 0

    @property
    def device_stream_nbytes(self) -> int:
        """Device bytes of the torch stream's index tensors this plan holds
        (``core.device_stream``); reads the memo without building them."""
        d = self._stream_memo.get("device")
        return d.nbytes if d is not None else 0

    @property
    def fused_stream_nbytes(self) -> int:
        """Device bytes of the K1 views this plan holds
        (``core.fused_stream``); reads the memo without building them."""
        f = self._stream_memo.get("fused")
        return f.nbytes if f is not None else 0

    def stream_apply(self, a_values, b_values, engine: str | None = None):
        """Differentiable numeric phase: C's values only.

        ``a_values``/``b_values`` are value vectors (torch tensors, which
        may require grad) aligned with the planned patterns, or ``[B, nnz]``
        stacks of them; the result is C's ``[nnz_c]`` (or ``[B, nnz_c]``)
        f32 values on the stream's structure (``plan.stream.c_rows``/
        ``c_col_ptr``), on the plan's device, and ``torch.autograd``
        differentiates it with two more replays of the stream.
        ``engine=None``/``"stream"`` lowers the replays through PyTorch ops
        (``core.device_stream``), ``"fused"`` through K1 (K1-b for stacks);
        any plan takes either.  A guarded plan raises (there is no stream to
        differentiate through).
        """
        if engine == "fused":
            from repro_torch.core.fused_stream import fused_fn as make
        elif engine in (None, "stream"):
            from repro_torch.core.device_stream import stream_fn as make
        else:
            raise ValueError(
                f"stream_apply supports engine=None/'stream'/'fused', "
                f"got {engine!r}")
        if np.ndim(a_values) == 2 and np.ndim(b_values) == 2:
            self.a.check_batched_compatible(a_values)
            self.b.check_batched_compatible(b_values)
            if a_values.shape[0] != b_values.shape[0]:
                raise ValueError(
                    f"batch mismatch: A has {a_values.shape[0]} value "
                    f"sets, B has {b_values.shape[0]}")
        else:
            self.a.check_compatible(a_values)
            self.b.check_compatible(b_values)
        return make(self)(a_values, b_values)

    def execute(self, a_values, b_values, *, stats: dict | None = None,
                validate: str | None = None,
                engine: str | None = None) -> CSC:
        """Numeric phase only: C for new values on the planned patterns.

        ``engine`` picks one of the backend's engines (``None``: its default
        for the method); ``validate="fingerprint"`` re-hashes a CSC
        operand's structure against the plan.
        """
        from repro_torch.core.executor import execute

        return execute(self, a_values, b_values, stats=stats,
                       validate=validate, engine=engine)

    def execute_batched(self, a_values, b_values, *,
                        stats: dict | None = None,
                        validate: str | None = None,
                        engine: str | None = None) -> list:
        """Batched numeric phase: B same-pattern multiplies through one
        execution of the plan.

        ``a_values``/``b_values``: :class:`~repro_torch.sparse.format.
        BatchedCSC` operands or raw ``[B, nnz]`` value stacks aligned with
        the planned patterns.  Returns the B results as a list of CSC
        matrices, bit-identical to a Python loop of :meth:`execute`.
        ``engine`` and ``validate`` as in :meth:`execute`.
        """
        from repro_torch.core.executor import execute_batched

        return execute_batched(self, a_values, b_values, stats=stats,
                               validate=validate, engine=engine)


def plan_device(contract, device) -> torch.device:
    """Where a plan of ``contract`` runs: a device backend's ``device``
    (``None`` is the card, :func:`~repro_torch.device.resolve_device`); the
    host backend's numpy always runs on the CPU, so ``None`` is the CPU
    there and any other device raises."""
    if contract.device_resident:
        return resolve_device(device)
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cpu":
        raise ValueError(
            f"backend={contract.name!r} runs numpy on the host; "
            f"device={device!r} does not apply (use backend='cuda' or "
            "'torch' on the card)")
    return dev


def check_method(method: str, contract) -> None:
    """Reject a method the planner does not know, or one ``contract``
    cannot plan (the host-only methods on the cuda backend)."""
    if method not in ALGORITHMS and not method.startswith(FAMILY_PREFIXES):
        raise ValueError(
            f"unknown method {method!r}; one of {list(ALGORITHMS)} or a "
            "'spars-*/hash-*/h-*' family name")
    if method in contract.excluded_methods:
        raise ValueError(
            f"method {method!r} has no {contract.name} kernel family "
            "(host-only)")


def plan_spgemm(
    a: CSC,
    b: CSC,
    method: str = "h-hash-256/256",
    *,
    backend: str = "cuda",
    t: float | None = None,
    b_min: int | None = None,
    b_max: int | None = None,
    device=None,
    stream_limit: int | None = None,
    block_cols: int = BLOCK_COLS,
    tile_cols: int | None = None,
    shards: int | None = None,
) -> SpgemmPlan:
    """Build the symbolic plan for C = A @ B (pattern-dependent work only).

    ``backend`` is ``"cuda"`` (the per-group kernels; the default),
    ``"torch"`` (the stream in PyTorch ops; every method spelling plans as
    ``"expand"``) or ``"host"`` (numpy; ``device`` must be the CPU).
    ``device`` (default ``"cuda"`` on the device backends) is where the
    plan's index tensors live and its numeric phase runs.  ``t`` moves a
    hybrid's split; ``b_min``/``b_max`` set the blocking of the host
    oracles, while the cuda kernels block by ``BLOCK_COLS`` lanes whatever
    they say (the method selects the family, as in the JAX package); the
    torch backend rejects all three.  The product stream is kept on the
    plan while it has at most ``stream_limit`` products (default
    ``fast.STREAM_MAX_PRODUCTS``); above that each stream execution
    rebuilds it and keeps nothing.

    ``block_cols`` (cuda plans only) is the lock-step kernels' lane-block
    width; ``tile_cols`` (a multiple of it, default ``block_cols``) bounds
    the C columns one launch computes, so a family is cut into
    ``tile_cols``-wide launches: it changes launches and peak memory, never
    values.

    ``backend="mesh"`` returns the
    :class:`~repro_torch.distributed.spgemm_mesh.ShardedSpgemmPlan` of
    :func:`~repro_torch.distributed.spgemm_mesh.plan_spgemm_mesh`: the tile
    grid placed over ``shards`` shards (default one a visible card) on
    ``device`` (``None``: shard d on ``cuda:d``), ``stream_limit`` acting
    as the per-shard guard.  Every other backend rejects ``shards``.
    """
    faults.check("plan_spgemm", key=(backend, method))
    if shards is not None and backend != "mesh":
        raise ValueError(
            f"shards= applies only to backend='mesh', not {backend!r}")
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    contract = backends.get_backend(backend)
    check_method(method, contract)
    backends.check_method_knobs(contract, t, b_min, b_max)
    if backend != "cuda" and (block_cols != BLOCK_COLS
                              or tile_cols is not None):
        raise ValueError(
            f"block_cols/tile_cols shape the kernel launches of "
            f"backend='cuda'; backend={backend!r} has none")
    if contract.canonical_method:
        method = contract.canonical_method
    if backend == "mesh":
        from repro_torch.distributed.spgemm_mesh import plan_spgemm_mesh

        return plan_spgemm_mesh(a, b, shards=shards,
                                shard_limit=stream_limit, device=device)
    params = resolve_params(method, t=t, b_min=b_min, b_max=b_max)
    dev = plan_device(contract, device)
    limit = (fast.STREAM_MAX_PRODUCTS if stream_limit is None
             else int(stream_limit))
    pre = layout = None
    if backend == "cuda":
        pre, layout = _plan_groups(a, b, method, params, dev, block_cols,
                                   tile_cols)
    elif contract.bit_exact_oracle:
        # the host oracles consume the paper's pre-processing
        if method.startswith(("spars", "hash")):
            pre = preprocess(a, b, t=np.inf, b_min=params["b_min"],
                             b_max=params["b_max"])
        elif method.startswith("h-"):
            pre = preprocess(a, b, t=params["t"], b_min=params["b_min"],
                             b_max=params["b_max"])
    return SpgemmPlan(method, backend, tuple(sorted(params.items())),
                      Pattern.of(a), Pattern.of(b), pre, layout, dev, limit)


# ---------------------------------------------------------------------------
# tiled plans: a 2-D grid of per-tile SpgemmPlans (method="auto")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One non-empty tile product ``A[:, k] @ B[k, n]`` of a tiled plan.

    The A tile's values are the contiguous range ``[a_vals[0], a_vals[1])``
    of the parent A values; the B tile's are ``b_parent[b_vals]`` (a gather:
    row slicing is not contiguous in CSC), with ``b_index`` the same indices
    on the grid's device for a device grid.  ``plan`` is an ordinary
    :class:`SpgemmPlan`, shared through the plan LRU with any other tile of
    identical pattern; ``engine`` is the engine the cost model chose for the
    tile (``None``: the child plan's default; ``"fused"``: K1).
    """

    k: int                       # row-block index (A column block)
    n: int                       # column-block index (B column block)
    a_vals: Tuple[int, int]
    b_vals: np.ndarray
    plan: SpgemmPlan
    engine: Optional[str] = None
    b_index: Optional[torch.Tensor] = None

    @property
    def method(self) -> str:
        # the candidate spelling the cost model chose: "torch"/"fused" tiles
        # carry an expand-method child plan on the torch backend
        if self.engine == "fused":
            return "fused"
        return "torch" if self.plan.backend == "torch" else self.plan.method


@dataclasses.dataclass(frozen=True)
class TiledSpgemmPlan:
    """Symbolic plan for ``C = A @ B`` as a 2-D grid of tile products.

    Built by :func:`plan_spgemm_tiled` (the ``method="auto"`` path of
    ``core.api.spgemm``): A is sliced into column blocks at ``k_bounds``, B
    into matching row blocks crossed with column blocks at ``n_bounds``, and
    every structurally non-empty tile gets its own child plan, whose method
    the cost model picked for the tile's work profile.  Execution
    (``core.executor.execute_tiled``) runs the children and merges: per
    column block, partials add over row blocks in k order; the blocks then
    stitch left to right.  A plan with a single row block is bit-identical
    per column to the untiled method.

    ``device`` is where a cuda or torch grid runs, children and merge; on a
    host grid, where its device tiles (``"torch"``/``"fused"``) run, while
    its numpy tiles and the merge run on the CPU.
    """

    backend: str
    a: Pattern
    b: Pattern
    k_bounds: np.ndarray         # [K+1] over A's columns / B's rows
    n_bounds: np.ndarray         # [N+1] over B's columns
    tiles: Tuple[TilePlan, ...]  # structurally non-empty tiles, n-major
    params: tuple                # frozen ("candidates", ...), ("tile", ...)
    device: torch.device

    method = "auto"

    @property
    def contract(self) -> "backends.ExecutionContract":
        return backends.get_backend(self.backend)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.a.shape[0], self.b.shape[1])

    @property
    def grid(self) -> Tuple[int, int]:
        return (len(self.k_bounds) - 1, len(self.n_bounds) - 1)

    @property
    def methods(self) -> dict:
        """{(k, n): chosen method} for every non-empty tile."""
        return {(t.k, t.n): t.method for t in self.tiles}

    def _distinct(self, attr: str) -> int:
        # children of identical pattern share one plan: count it once
        return sum({id(t.plan): getattr(t.plan, attr)
                    for t in self.tiles}.values())

    @property
    def stream_nbytes(self) -> int:
        """Host stream bytes held via the child plans (each distinct child
        once).  The guard bounds each tile's stream on its own, so a grid
        can hold many guard-sized streams."""
        return self._distinct("stream_nbytes")

    @property
    def device_stream_nbytes(self) -> int:
        """Torch-stream index bytes held via the child plans."""
        return self._distinct("device_stream_nbytes")

    @property
    def fused_stream_nbytes(self) -> int:
        """K1 view bytes held via the child plans."""
        return self._distinct("fused_stream_nbytes")

    @property
    def cache_key(self) -> tuple:
        """The plan LRU's key of this plan (``core.api``)."""
        own = dict(self.params)
        return tiled_plan_key(self.a.fingerprint, self.b.fingerprint,
                              self.backend, own["tile"], own["candidates"],
                              own["profile"], own["stream_guard"],
                              self.device)

    def execute(self, a_values, b_values, *, stats: dict | None = None,
                validate: str | None = None,
                engine: str | None = None):
        """Numeric phase: run every tile's plan, merge row blocks, stitch.

        ``engine`` is forwarded to every child plan and must exist on each
        (``None`` lets each tile run the engine the cost model chose).
        """
        from repro_torch.core.executor import execute_tiled

        return execute_tiled(self, a_values, b_values, stats=stats,
                             validate=validate, engine=engine)

    def execute_batched(self, a_values, b_values, *,
                        stats: dict | None = None,
                        validate: str | None = None,
                        engine: str | None = None) -> list:
        """Batched numeric phase over ``[B, nnz]`` value stacks (or
        BatchedCSC operands); each result bit-identical to :meth:`execute`
        on its value set."""
        from repro_torch.core.executor import execute_tiled_batched

        return execute_tiled_batched(self, a_values, b_values, stats=stats,
                                     validate=validate, engine=engine)


def tiled_plan_key(a_fp: str, b_fp: str, backend: str, spec: tuple,
                   candidates: tuple, profile: str, guard: int,
                   device) -> tuple:
    """The LRU key of a tiled plan: both fingerprints, ``"auto"``, the
    backend, the normalized tile spec, the resolved candidates, the
    constants' tag, the stream guard (it steers the host and torch choices
    and bounds every child's stream) and the device."""
    return (a_fp, b_fp, "auto", backend, spec, tuple(candidates), profile,
            guard, str(device))


def normalize_tile_spec(tile) -> tuple:
    """Canonical ``(k_width, n_width)`` form of the ``tile=`` argument.

    ``None``: both axes auto-sized from nnz; an int: that column width on
    the n axis (k auto); a 2-tuple: per-axis widths, ``None`` meaning auto
    for that axis.
    """
    if tile is None:
        return (None, None)
    if isinstance(tile, (int, np.integer)):
        spec = (None, int(tile))
    else:
        spec = tuple(tile)
    if len(spec) != 2:
        raise ValueError(
            f"tile must be None, an int, or a (k_width, n_width) pair; "
            f"got {tile!r}")
    out = []
    for w in spec:
        if w is None:
            out.append(None)
        elif isinstance(w, (int, np.integer)) and int(w) >= 1:
            out.append(int(w))
        else:
            raise ValueError(f"tile widths must be ints >= 1 or None, "
                             f"got {w!r}")
    return tuple(out)


def tiled_device(contract, device) -> torch.device:
    """Where a tiled plan of ``contract`` runs its device work: a device
    grid's device (``None`` is the card, resolved now), or for a host grid
    the device of its device tiles, resolved only when a tile goes there
    (a host grid that picks none runs without a card)."""
    if contract.device_resident:
        return resolve_device(device)
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; 'cuda' or 'cpu'")
    return dev


def _pattern_csc(p: Pattern) -> CSC:
    """A host CSC of the pattern with zero values: what slicing reads at
    plan time, whatever device the caller's values lie on."""
    return CSC(as_tensor(np.zeros(p.nnz, np.float32)), p.row_indices,
               p.col_ptr, p.shape)


def plan_spgemm_tiled(
    a: CSC,
    b: CSC,
    *,
    backend: str = "cuda",
    tile=None,
    candidates: tuple | None = None,
    cache: bool = True,
    constants: CostConstants | None = None,
    device=None,
) -> TiledSpgemmPlan:
    """Build the tiled ``method="auto"`` plan for C = A @ B.

    ``tile``: see :func:`normalize_tile_spec`; auto axes use nnz-balanced
    boundaries with block counts from
    :func:`~repro_torch.sparse.partition.auto_tile_grid`.  ``candidates``
    restricts the per-tile method choice (default
    ``cost.AUTO_CANDIDATES[backend]``); with a single candidate every tile
    runs that method, so a grid with one row block is bit-identical to the
    untiled method.  ``cache=True`` routes child plans through the plan
    LRU, so tiles with identical patterns share one plan.  ``constants``
    replaces the machine profile's (``core.profile``).

    ``device``: a cuda or torch grid's device (``None`` is the card).  A
    host grid runs its numpy tiles on the CPU and its ``"torch"``/
    ``"fused"`` tiles on ``device`` (``None`` is the card, needed only if a
    tile goes there), and brings those tiles' results back to the host for
    its numpy merge, as the JAX package brings its device tiles back; so
    ``backend="host"`` takes a ``device`` here, which its untiled plans
    reject.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    contract = backends.get_backend(backend)
    cands = check_candidates(contract, candidates)
    dev = tiled_device(contract, device)
    a_pat, b_pat = Pattern.of(a), Pattern.of(b)
    a0, b0 = _pattern_csc(a_pat), _pattern_csc(b_pat)

    k_width, n_width = normalize_tile_spec(tile)
    auto_k, auto_n = auto_tile_grid(a0, b0)
    k_bounds = (width_col_bounds(a0.n_cols, k_width) if k_width
                else nnz_balanced_col_bounds(a0, auto_k))
    n_bounds = (width_col_bounds(b0.n_cols, n_width) if n_width
                else nnz_balanced_col_bounds(b0, auto_n))

    def tile_plan(ta, tb, method):
        # "torch" (the torch stream) and "fused" (K1) ride an expand child
        # plan on the torch backend, so a host grid can mix numpy tiles with
        # device tiles; the engine lives on the TilePlan, so one pattern
        # shares one child plan in the LRU
        if method in ("torch", "fused"):
            meth, be = "expand", "torch"
            engine = "fused" if method == "fused" else None
        else:
            meth, be, engine = method, backend, None
        child_dev = dev if backends.get_backend(be).device_resident \
            else None
        if cache:
            from repro_torch.core.api import cached_plan

            return cached_plan(ta, tb, meth, backend=be,
                               device=child_dev), engine
        return plan_spgemm(ta, tb, meth, backend=be,
                           device=child_dev), engine

    # A column blocks depend only on k: slice them once, not once per n block
    a_tiles = [csc_col_slice(a0, int(k0), int(k1))
               for k0, k1 in zip(k_bounds[:-1], k_bounds[1:])]
    tiles: list[TilePlan] = []
    for ni, (j0, j1) in enumerate(zip(n_bounds[:-1], n_bounds[1:])):
        b_col, (b_lo, _) = csc_col_slice(b0, int(j0), int(j1))
        for ki, (k0, k1) in enumerate(zip(k_bounds[:-1], k_bounds[1:])):
            a_tile, (a_lo, a_hi) = a_tiles[ki]
            if a_tile.nnz == 0:
                continue
            b_tile, rel = csc_row_slice(b_col, int(k0), int(k1))
            if b_tile.nnz == 0:
                continue
            stats = tile_stats(a_tile, b_tile)
            if stats.flops == 0:
                continue  # stored B entries only reference empty A columns
            method = choose_method(stats, backend, cands, constants)
            child, engine = tile_plan(a_tile, b_tile, method)
            b_vals = (b_lo + rel).astype(np.int64)
            tiles.append(TilePlan(
                k=ki, n=ni, a_vals=(a_lo, a_hi), b_vals=b_vals, plan=child,
                engine=engine,
                b_index=(torch.as_tensor(b_vals, device=dev)
                         if contract.device_resident else None)))

    # the constants the choices were ranked under: a plan built on one
    # calibration never aliases one built on another, on the defaults or on
    # caller-given constants
    if constants is None:
        from repro_torch.core import profile

        profile_tag = profile.current_profile().tag
    else:
        profile_tag = "explicit"
    params = (("candidates", cands),
              ("profile", profile_tag),
              # the guard steers the host and torch choices and bounds every
              # child plan's stream
              ("stream_guard", fast.STREAM_MAX_PRODUCTS),
              ("tile", (k_width, n_width)))
    return TiledSpgemmPlan(backend, a_pat, b_pat,
                           np.asarray(k_bounds, np.int64),
                           np.asarray(n_bounds, np.int64),
                           tuple(tiles), params, dev)


def _plan_groups(a, b, method, params, dev, block_cols, tile_cols):
    """The per-group launch schedule (mirrors the JAX package's
    ``_plan_pallas``), built in numpy and lifted once to ``dev``."""
    if tile_cols is None:
        tile_cols = block_cols
    if block_cols < 1 or tile_cols < 1 or tile_cols % block_cols:
        raise ValueError(
            f"tile_cols={tile_cols} not a multiple of block_cols={block_cols}")
    n = b.n_cols
    a_rows, a_gather, a_mask, a_nnz = csc_pad_gather(a)
    b_rows, b_gather, b_mask, b_nnz = csc_pad_gather(b)

    def lift(x):
        return torch.as_tensor(x, device=dev)

    groups: list[KernelGroup] = []

    def add_group(kind, cols, steps=None, h=None):
        cols = np.asarray(cols, np.int64)
        n_real = len(cols)
        if n_real == 0:
            return
        n_pad = -(-n_real // block_cols) * block_cols
        sel = np.zeros(n_pad, np.int64)
        sel[:n_real] = cols
        valid = np.zeros(n_pad, bool)
        valid[:n_real] = True
        g_rows = np.where(valid[:, None], b_rows[sel], 0).astype(np.int32)
        g_nnz = np.where(valid, b_nnz[sel], 0).astype(np.int32)
        if steps is not None:
            steps = np.asarray(steps, np.int32)
            assert len(steps) == n_pad // block_cols, (len(steps), n_pad)
            steps = lift(steps)
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
        # bounds collapse to block_cols (the named method only selects the
        # family), exactly as in the JAX package
        pre = preprocess(a, b, t=tt, b_min=block_cols, b_max=block_cols)
        head = pre.perm[: pre.split]

    # the kernels process each lane independently, so cutting a family into
    # tile_cols-wide launches changes launches and peak memory, never values
    for c0 in range(0, len(head), tile_cols):
        add_group("spa", head[c0: c0 + tile_cols])

    if method != "spa" and pre.blocks.n_blocks:
        fam = "hash" if "hash" in method else "spars"
        starts, sizes = pre.blocks.starts, pre.blocks.sizes
        n_blocks = pre.blocks.n_blocks
        # per-block trip count: the block max of steps_per_column (a lane
        # takes one step per stored B entry even on an empty A column)
        steps_sorted = steps_per_column(a, b)[pre.perm]
        steps_all = np.maximum.reduceat(steps_sorted, starts).astype(np.int32)
        if fam == "hash":
            # blocks with equal table size H form contiguous runs (H shrinks
            # monotonically along sorted blocks, Section 3.2)
            hs = pre.hash_sizes
            run_bounds = np.concatenate(
                ([0], np.nonzero(np.diff(hs))[0] + 1, [n_blocks]))
            runs = list(zip(run_bounds[:-1], run_bounds[1:]))
        else:
            runs = [(0, n_blocks)]
        blocks_per_tile = tile_cols // block_cols
        for r0, r1 in runs:
            h = int(pre.hash_sizes[r0]) if fam == "hash" else None
            for i0 in range(r0, r1, blocks_per_tile):
                i1 = min(i0 + blocks_per_tile, r1)
                lo = int(starts[i0])
                hi = int(starts[i1 - 1] + sizes[i1 - 1])
                add_group(fam, pre.perm[lo:hi], steps=steps_all[i0:i1], h=h)

    # C column j holds at most min(Op_j, m) entries: the compaction's slots
    ops = ops_per_column(a, b) if pre is None else pre.ops
    cap = np.minimum(ops, a.n_rows)
    tile_cells = max(((a.n_rows if g.h is None else g.h) * g.n_real
                      for g in groups), default=0)
    layout = KernelLayout(
        block_cols=block_cols,
        tile_cols=tile_cols,
        a_rows=lift(a_rows),
        a_nnz=lift(a_nnz.astype(np.int32)),
        a_gather=lift(a_gather),
        a_mask=lift(a_mask),
        c_slots=ColumnSlots.of(cap, tile_cells, dev),
        groups=tuple(groups),
    )
    return pre, layout
