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
from repro_torch.core.planner import BLOCK_COLS, SpgemmPlan
from repro_torch.sparse.format import CSC, BatchedCSCBuilder, CSCBuilder, \
    _np, as_tensor, padded_values, padded_values_batched

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
                          block_cols=BLOCK_COLS)
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


register_executor("host", "naive", _host_naive, _host_naive_batched)
register_executor("host", "stream", _host_stream, _host_stream_batched)
register_executor("cuda", "naive", _execute_groups, _execute_groups_batched)
register_executor("torch", "stream", execute_torch, execute_torch_batched)
# one executor pair serves both device backends: K1 replays the plan's
# product stream, which every contract here carries
for _backend in ("cuda", "torch"):
    register_executor(_backend, "fused", execute_fused,
                      execute_fused_batched)
