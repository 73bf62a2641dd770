"""Numeric SpGEMM execution of a cached symbolic plan.

``execute(plan, a_values, b_values)`` runs only the value-dependent work of
C = A @ B; every pattern-dependent decision (sorting, blocking, hash sizing,
padded layouts, kernel groups, the product stream) was made once by
``core.planner.plan_spgemm``.

Execution dispatches through the backend registry: each backend registers
one executor pair per engine (:func:`register_executor`), and
:func:`resolve_engine` checks the caller's ``engine=`` against the plan's
:class:`~repro_torch.core.backends.ExecutionContract`.  The pairs:

* ``("host", "naive")`` — the faithful numpy oracles (``core.naive``), fed
  the plan's pre-processing: the JAX package's host results bit for bit,
  each column's rows in discovery order.  Batched: SPA runs one pass over
  the value axis, the other methods a loop.
* ``("host", "stream")`` — the numpy product stream (``core.fast``), the
  default of ``expand``.
* ``("cuda", "naive")`` — the counterpart of the JAX package's
  ``_execute_pallas``: gather each group's padded values with the plan's
  resident index tensors, launch one kernel per group, and compact each
  group's output into CSC on the plan's device.  The host waits for the
  card once per execution, to read the result's nnz.  Batched: every group
  launches once for all B (the batched kernels K2-b … K4-b) and one host
  wait reads all B nnz.
* ``("cuda", "fused")`` and ``("torch", "fused")`` — one K1 launch over the
  plan's product stream (``core.fused_stream``); no host wait, since the
  stream fixes the result's nnz at plan time.  Batched: one K1-b launch.
* ``("torch", "stream")`` — the product stream in PyTorch ops on the plan's
  device (``core.device_stream``), no host wait either.

Launch counts do not depend on B up to ``MAX_BATCH`` value sets; a larger
batch runs as consecutive executions of at most that many.  Each batched
result is bit-identical to a looped :func:`execute`.

An A with no rows makes C an empty ``0 x n`` CSC: every per-group
execution of such a plan returns it without a launch.

``execute_tiled[_batched](plan, ...)`` runs a
:class:`~repro_torch.core.planner.TiledSpgemmPlan` (``method="auto"``):
every tile's child plan on its slices of the values, then the merge of
row-block partials and the stitch of column blocks.  A host grid merges on
the host in numpy (its device tiles' results come back for it, as in the
JAX package); a cuda or torch grid merges on its device
(``sparse.partition.merge_and_stitch_device``), in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fast, naive
from repro_torch.core.backends import check_engine, default_engine, \
    get_backend
from repro_torch.core.device_stream import _check_batch, _values, \
    execute_torch, execute_torch_batched
from repro_torch.core.fused_stream import execute_fused, \
    execute_fused_batched
from repro_torch.core.expand import spgemm_expand
from repro_torch.core.planner import SpgemmPlan
from repro_torch.sparse.format import CSC, BatchedCSCBuilder, CSCBuilder, \
    _np, as_tensor, padded_values, padded_values_batched
from repro_torch.sparse.partition import csc_empty, csc_hstack, \
    merge_and_stitch_device, merge_csc_partials

# (backend, resolved engine) -> (execute_fn, execute_batched_fn), each
# fn(plan, a_values, b_values, *, stats, validate)
_DISPATCH: dict = {}


def register_executor(backend: str, engine: str, fn, fn_batched) -> None:
    """Register the executor pair of one backend's engine."""
    _DISPATCH[(backend, engine)] = (fn, fn_batched)


def resolve_engine(plan, engine: str | None) -> str:
    """The engine an execution will run: explicit choice or the default
    for the plan's method (host: ``"stream"`` for ``expand``)."""
    contract = get_backend(plan.backend)
    check_engine(contract, engine)
    return default_engine(contract, plan.method) if engine is None \
        else engine


def execute(plan: SpgemmPlan, a_values, b_values, *,
            stats: dict | None = None, validate: str | None = None,
            engine: str | None = None) -> CSC:
    """C = A @ B for new numeric values on the plan's sparsity patterns.

    ``a_values``/``b_values``: CSC matrices or raw nnz-length value vectors
    (torch tensors or numpy arrays), on any device: a device engine moves
    them to the plan's device once, the host backend reads them as numpy.
    Shapes and nnz are checked against the planned patterns (O(1));
    ``validate="fingerprint"`` also re-hashes a CSC operand's structure
    (O(nnz)), on every engine.  ``stats``, if given, is filled with the
    engine and its own figures (launches and tile shapes; or the stream's
    products and whether the plan keeps it).
    """
    fn, _ = _DISPATCH[(plan.backend, resolve_engine(plan, engine))]
    return fn(plan, a_values, b_values, stats=stats, validate=validate)


def execute_batched(plan: SpgemmPlan, a_values, b_values, *,
                    stats: dict | None = None, validate: str | None = None,
                    engine: str | None = None) -> list:
    """B same-pattern multiplies through one execution of the plan.

    ``a_values``/``b_values``: :class:`~repro_torch.sparse.format.BatchedCSC`
    operands or raw ``[B, nnz]`` value stacks (row b = value set b, aligned
    with the planned pattern), on any device.  Returns a list of B CSC
    results, bit-identical to ``[execute(plan, a_b, b_b) ...]``.  ``stats``
    as in :func:`execute`, plus ``batch``.
    """
    _, fn = _DISPATCH[(plan.backend, resolve_engine(plan, engine))]
    return fn(plan, a_values, b_values, stats=stats, validate=validate)


# ---------------------------------------------------------------------------
# host executors (the naive oracles and the numpy product stream)
# ---------------------------------------------------------------------------


def _host_values(x) -> np.ndarray:
    return _np(x.values if isinstance(x, CSC) else x)


def _host_naive(plan, a_values, b_values, *, stats=None,
                validate=None) -> CSC:
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    if stats is not None:
        stats["engine"] = "naive"
    return _execute_host(plan, _host_values(a_values),
                         _host_values(b_values))


def _host_stream(plan, a_values, b_values, *, stats=None,
                 validate=None) -> CSC:
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    return fast.execute_stream(plan, _host_values(a_values),
                               _host_values(b_values), stats=stats)


def _host_naive_batched(plan, a_values, b_values, *, stats=None,
                        validate=None) -> list:
    av = _np(plan.a.batched_values(a_values, validate))
    bv = _np(plan.b.batched_values(b_values, validate))
    batch = _check_batch(av, bv)
    vectorized = plan.method == "spa"
    if vectorized:
        out = _spa_host_batched(plan, av, bv)
    else:
        out = [_execute_host(plan, av[b], bv[b]) for b in range(batch)]
    if stats is not None:
        stats["engine"] = "naive"
        stats["batch"] = batch
        stats["path"] = "vectorized" if vectorized else "loop"
    return out


def _host_stream_batched(plan, a_values, b_values, *, stats=None,
                         validate=None) -> list:
    av = _np(plan.a.batched_values(a_values, validate))
    bv = _np(plan.b.batched_values(b_values, validate))
    batch = _check_batch(av, bv)
    out = fast.execute_stream_batched(plan, av, bv, stats=stats)
    if stats is not None:
        stats["batch"] = batch
    return out


def _execute_host(plan: SpgemmPlan, a_values: np.ndarray,
                  b_values: np.ndarray) -> CSC:
    """The plan's method through its naive oracle, on host values."""
    a = plan.a.with_values(a_values)
    b = plan.b.with_values(b_values)
    method = plan.method
    params = dict(plan.params)
    if method == "spa":
        return naive.spa_numpy(a, b)
    if method == "expand":
        return spgemm_expand(a, b)
    if method == "esc":
        return naive.esc_numpy(a, b)
    if method.startswith("spars"):
        return naive.spars_numpy(a, b, plan.pre)
    if method.startswith("hash"):
        return naive.hash_numpy(a, b, plan.pre)
    return naive.hybrid_numpy(
        a, b, t=params["t"], b_min=params["b_min"], b_max=params["b_max"],
        accumulator=params["accumulator"], pre=plan.pre)


def _spa_host_batched(plan: SpgemmPlan, av: np.ndarray,
                      bv: np.ndarray) -> list:
    """Batched ``naive.spa_numpy``: one pass, the SPA arrays carry [B, m];
    every operation repeats the unbatched one element-wise across the
    batch, so each result equals it bit for bit."""
    a_cp, a_rows = plan.a.col_ptr, plan.a.row_indices
    b_cp, b_rows = plan.b.col_ptr, plan.b.row_indices
    m, n = plan.shape
    batch = av.shape[0]
    dtype = np.result_type(av.dtype, bv.dtype)

    spa_values = np.zeros((batch, m), dtype)
    spa_flags = np.zeros(m, bool)       # pattern-only: shared by the batch

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros((batch, 0), dtype)] * n
    for j in range(n):
        touched = []
        for p in range(b_cp[j], b_cp[j + 1]):
            k = b_rows[p]
            sl = slice(a_cp[k], a_cp[k + 1])
            ar = a_rows[sl]
            spa_values[:, ar] += av[:, sl] * bv[:, p, None]
            new = ar[~spa_flags[ar]]
            spa_flags[new] = True
            if len(new):
                touched.append(new)
        idx = np.concatenate(touched) if touched else np.zeros(0, np.int32)
        out_rows[j] = idx.astype(np.int32)
        out_vals[j] = spa_values[:, idx].astype(dtype)
        spa_values[:, idx] = 0
        spa_flags[idx] = False
    return _assemble_batched(batch, out_rows, out_vals, (m, n), dtype)


def _assemble_batched(batch, cols_rows, cols_vals, shape, dtype) -> list:
    """Batched ``naive._assemble``: per-column [B, cnt] value slabs."""
    n = shape[1]
    col_ptr = np.zeros(n + 1, np.int32)
    np.cumsum([len(r) for r in cols_rows], out=col_ptr[1:])
    if col_ptr[-1]:
        rows = np.concatenate(cols_rows).astype(np.int32)
        vals = np.concatenate(cols_vals, axis=1)
    else:
        rows = np.zeros(0, np.int32)
        vals = np.zeros((batch, 0), dtype)
    vals = as_tensor(vals)
    return [CSC(vals[b], rows, col_ptr, shape) for b in range(batch)]


# ---------------------------------------------------------------------------
# the per-group kernel schedule (cuda, engine="naive")
# ---------------------------------------------------------------------------


def _execute_groups(plan: SpgemmPlan, a_values, b_values, *,
                    stats: dict | None = None,
                    validate: str | None = None) -> CSC:
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    dev = plan.device
    return _run_groups(plan, _values(a_values, dev)[: plan.a.nnz],
                       _values(b_values, dev)[: plan.b.nnz],
                       CSCBuilder(plan.shape, plan.layout.c_slots),
                       batched=False, stats=stats)


def _execute_groups_batched(plan: SpgemmPlan, a_values, b_values, *,
                            stats: dict | None = None,
                            validate: str | None = None) -> list:
    from repro_torch.kernels._checks import batch_chunks

    av = plan.a.batched_values(a_values, validate)
    bv = plan.b.batched_values(b_values, validate)
    batch = _check_batch(av, bv)
    dev = plan.device
    parts = batch_chunks(av.to(device=dev, dtype=torch.float32),
                         bv.to(device=dev, dtype=torch.float32))
    out = []
    for a_part, b_part in parts:
        out += _run_groups(plan, a_part, b_part,
                           BatchedCSCBuilder(len(a_part), plan.shape,
                                             plan.layout.c_slots),
                           batched=True, stats=stats)
    if stats is not None:
        stats["batch"] = batch
        stats["n_launches"] *= len(parts)
    return out


def _run_groups(plan: SpgemmPlan, av, bv, builder, *, batched: bool,
                stats: dict | None):
    """Gather, launch and compact every group of the plan: one kernel
    launch per group, for one value set (``av``/``bv`` f32 ``[nnz]``) or
    for B (``[B, nnz]``, the batched kernels).  With ``m == 0`` C has no
    cells: no group launches (K3 would step on an empty A column's padding
    row 0) and the builder gives the empty ``0 x n`` result."""
    from repro_torch.kernels import ops as kops  # kernels import core

    lay = plan.layout
    m = plan.shape[0]
    groups = lay.groups if m else ()
    pad = padded_values_batched if batched else padded_values
    run = {"spa": kops.run_spa_batched if batched else kops.run_spa,
           "spars": kops.run_spars_batched if batched else kops.run_spars,
           "hash": kops.run_hash_batched if batched else kops.run_hash}
    if groups:
        a_arrs = (lay.a_rows, pad(av, lay.a_gather, lay.a_mask), lay.a_nnz)
    for g in groups:
        out = run[g.kind](g, a_arrs, pad(bv, g.b_vgather, g.b_vmask), m=m,
                          block_cols=lay.block_cols)
        if g.kind == "hash":
            builder.add_hash_tables(g.cols_t, *out)
        else:
            builder.add_dense_tile(g.cols_t, out)
    c = builder.build()
    if stats is not None:
        stats["engine"] = "naive"
        stats["tile_shapes"] = list(builder.tile_shapes)
        stats["peak_tile_elems"] = builder.peak_tile_elems
        stats["n_launches"] = len(groups)   # independent of the batch
        stats["result_shape"] = plan.shape
    return c


# ---------------------------------------------------------------------------
# tiled execution: per-tile plans + the merge/stitch reduction
# ---------------------------------------------------------------------------


def _check_tile_engines(plan, engine) -> None:
    """An explicit engine must hold on every tile of the grid.

    A host grid may mix numpy tiles with torch-backend device tiles;
    silently swapping the engine of a tile that lacks the requested one
    would hand back f32 device results where ``engine="naive"`` promised
    the bit-exact oracles, so it raises instead (``engine=None`` runs each
    tile's own engine).
    """
    if engine is None:
        return
    missing = sorted({t.plan.backend for t in plan.tiles
                      if engine not in t.plan.contract.engines})
    if missing:
        raise ValueError(
            f"engine={engine!r} is not available on every tile of this "
            f"grid (missing on {missing} tile backends); use engine=None "
            "for per-tile defaults, or restrict candidates= at plan time")


def _grid_values(plan, x, batched: bool, pattern, validate):
    """The operand's values as the grid slices them: host numpy (dtype
    kept) on a host grid, f32 on the grid's device otherwise."""
    if batched:
        v = pattern.batched_values(x, validate)
    else:
        pattern.check_compatible(x, validate)
        v = as_tensor(x.values if isinstance(x, CSC) else x)[: pattern.nnz]
    if plan.contract.device_resident:
        return v.to(device=plan.device, dtype=torch.float32)
    return _np(v)


def _tile_values(tile, av, bv):
    """The parent values sliced down to one tile (pattern-static)."""
    lo, hi = tile.a_vals
    idx = tile.b_vals if tile.b_index is None else tile.b_index
    return av[..., lo:hi], bv[..., idx]


def _merge_and_stitch(plan, per_block, dtype) -> CSC:
    """Reduce per-column-block partial lists into the final CSC, on the
    host (numpy, the JAX package's merge).

    ``per_block[ni]`` holds the row-block partials of column block ``ni``
    in k-ascending order.  Each block merges (a single partial passes
    through bit-identically), then the blocks stitch left to right; both
    read a device tile's result back to the host.
    """
    m = plan.shape[0]
    blocks = []
    for ni, (j0, j1) in enumerate(zip(plan.n_bounds[:-1],
                                      plan.n_bounds[1:])):
        shape = (m, int(j1 - j0))
        parts = per_block[ni]
        if not parts:
            blocks.append(csc_empty(shape, dtype))
        else:
            blocks.append(merge_csc_partials(parts, shape, dtype=dtype))
    if not blocks:
        return csc_empty((m, 0), dtype)
    return csc_hstack(blocks, m)


def _reduce(plan, per_block, dtype, merge_stats):
    """The grid's result from its per-block partials: the device merge on
    a cuda or torch grid, the host merge on a host grid."""
    if plan.contract.device_resident:
        return merge_and_stitch_device(per_block, plan.n_bounds,
                                       plan.shape[0], plan.device,
                                       stats=merge_stats)
    return _merge_and_stitch(plan, per_block, dtype)


def _record_tile_stats(plan, stats, child_stats, merge_syncs):
    if stats is None:
        return
    stats["grid"] = plan.grid
    stats["tiles"] = [
        {"k": t.k, "n": t.n, "method": t.method} for t in plan.tiles]
    stats["methods"] = sorted({t.method for t in plan.tiles})
    stats["merged_blocks"] = len(
        {t.n for t in plan.tiles
         if sum(u.n == t.n for u in plan.tiles) > 1})
    stats["result_shape"] = plan.shape
    if child_stats:
        stats["n_launches"] = sum(
            s.get("n_launches", 0) for s in child_stats)
        stats["peak_tile_elems"] = max(
            (s.get("peak_tile_elems", 0) for s in child_stats), default=0)
    if plan.contract.device_resident:
        # a per-group child waits once for its result's nnz, a stream child
        # never; the merge once for all merged blocks of one value set
        stats["host_syncs"] = sum(
            s.get("engine") == "naive" for s in child_stats) + merge_syncs


def _child_stats(plan, stats):
    return {} if stats is not None and plan.backend == "cuda" else None


def execute_tiled(plan, a_values, b_values, *, stats: dict | None = None,
                  validate: str | None = None,
                  engine: str | None = None) -> CSC:
    """Numeric phase of a :class:`~repro_torch.core.planner.TiledSpgemmPlan`.

    Runs every tile's child plan on the tile's value slices, adds row-block
    partials per column block (k ascending; a single row block passes
    through bit-identically) and stitches the column blocks.  ``engine`` is
    forwarded to every child plan and must exist on every tile's backend
    (:func:`_check_tile_engines`); ``engine=None`` runs each tile's chosen
    engine.  ``stats`` records the grid and the per-tile methods, and on a
    cuda grid the launches summed over tiles, the peak tile, and
    ``host_syncs`` (each per-group child's one, and the merge's).
    """
    check_engine(plan.contract, engine)
    _check_tile_engines(plan, engine)
    av = _grid_values(plan, a_values, False, plan.a, validate)
    bv = _grid_values(plan, b_values, False, plan.b, validate)
    dtype = np.result_type(av.dtype, bv.dtype) \
        if isinstance(av, np.ndarray) else None
    per_block = {ni: [] for ni in range(plan.grid[1])}
    child_stats = []
    for tile in plan.tiles:
        ta, tb = _tile_values(tile, av, bv)
        cs = _child_stats(plan, stats)
        per_block[tile.n].append(tile.plan.execute(
            ta, tb, stats=cs,
            engine=engine if engine is not None else tile.engine))
        if cs is not None:
            child_stats.append(cs)
    merge_stats: dict = {}
    out = _reduce(plan, per_block, dtype, merge_stats)
    _record_tile_stats(plan, stats, child_stats,
                       merge_stats.get("merge_syncs", 0))
    return out


def execute_tiled_batched(plan, a_values, b_values, *,
                          stats: dict | None = None,
                          validate: str | None = None,
                          engine: str | None = None) -> list:
    """Batched tiled execution: B value sets through one plan traversal.

    Each tile's child plan executes batched once (one launch set per tile,
    independent of B on a cuda grid); the merge and stitch then run per
    batch element, since a cuda child's structure may differ between
    elements.  Each result is bit-identical to :func:`execute_tiled` on its
    value set.  ``engine`` as in :func:`execute_tiled`.
    """
    check_engine(plan.contract, engine)
    _check_tile_engines(plan, engine)
    av = _grid_values(plan, a_values, True, plan.a, validate)
    bv = _grid_values(plan, b_values, True, plan.b, validate)
    batch = _check_batch(av, bv)
    dtype = np.result_type(av.dtype, bv.dtype) \
        if isinstance(av, np.ndarray) else None
    per_block = [{ni: [] for ni in range(plan.grid[1])}
                 for _ in range(batch)]
    child_stats = []
    for tile in plan.tiles:
        ta, tb = _tile_values(tile, av, bv)
        cs = _child_stats(plan, stats)
        outs = tile.plan.execute_batched(
            ta, tb, stats=cs,
            engine=engine if engine is not None else tile.engine)
        for bi, c in enumerate(outs):
            per_block[bi][tile.n].append(c)
        if cs is not None:
            child_stats.append(cs)
    merge_syncs = 0
    out = []
    for bi in range(batch):
        merge_stats: dict = {}
        out.append(_reduce(plan, per_block[bi], dtype, merge_stats))
        merge_syncs += merge_stats.get("merge_syncs", 0)
    _record_tile_stats(plan, stats, child_stats, merge_syncs)
    if stats is not None:
        stats["batch"] = batch
    return out


register_executor("host", "naive", _host_naive, _host_naive_batched)
register_executor("host", "stream", _host_stream, _host_stream_batched)
register_executor("cuda", "naive", _execute_groups, _execute_groups_batched)
register_executor("torch", "stream", execute_torch, execute_torch_batched)
# one executor pair serves both device backends: K1 replays the plan's
# product stream, which every contract here carries
for _backend in ("cuda", "torch"):
    register_executor(_backend, "fused", execute_fused,
                      execute_fused_batched)
