"""Multi-shard SpGEMM: the tile grid and product stream across D shards.

The port's copy of the JAX package's ``repro/distributed/spgemm_mesh.py``
(``backend="mesh"``).  One device keeps a product stream only while it fits
the plan-memory guard (``fast.STREAM_MAX_PRODUCTS``); past it every call
rebuilds the stream.  A mesh plan applies the guard *per shard*:

* the outer-block-product grid, ``C[:, n] = sum_k A[:, k] @ B[k, n]``,
  gives tiles whose child streams each fit ``shard_limit``;
* the tiles are placed on shards by greedy LPT on the cost model's
  torch-stream cost (heaviest first onto the least loaded shard);
* every tile's stream is rewritten at plan time into *global* coordinates
  (positions into the whole A and B value arrays, and C slots of the
  plan-wide output structure, the union of the tiles' structures merged per
  column block in k order by ``merge_csc_partials``), so the runtime
  reduction adds contiguous destination bins and never scatters.

**Planning** (host numpy) is the reference's, step for step: the grid, the
child plans (``"expand"`` plans on the torch backend, through the plan
LRU), the placement, the global structure and each shard's index stream in
the plan's n-major, k-ascending order (:class:`ShardStream`).

**Execution** is one process driving D shard devices, the counterpart of
the reference's single controller over a ``shard_map``.  A shard's slice
need not be padded to the longest shard's: each shard keeps its own
:class:`~repro_torch.core.device_stream.StreamView`, its products sorted
stably by C slot at plan time (``torch.segment_reduce`` wants contiguous
segments, and one column block's tiles interleave their slots), and
replays into the padded slot axis of ``s_pad = D * ceil((nnz_c + 1) / D)``
slots.  Bin d of the result (slots ``[d * s_pad / D, (d + 1) * s_pad / D)``)
is the sum of every shard's bin d, added on shard d's device left to right
in ascending shard order: the reference's ``psum_scatter``, plan-static,
with no atomics.  The bins join on shard 0's device; no step reads a value
back to the host.

The contraction is bilinear, so its gradients are two more sharded replays
(products sorted by A or B position, placed through the distinct positions,
reduced the same way), installed with
:func:`~repro_torch.core.device_stream.bilinear_custom_vjp`.

**Devices.**  ``device=None``: shard d runs on ``cuda:d``, one card a
shard, and ``shards=None`` means one shard a visible card; a plan for more
shards than cards may be built, and its execution raises.  ``device=<one
device>``: every shard runs on that device, replaying its own slice; this
is how D > 1 runs on one card, and how the CPU tests run.  The code is the
same either way: a move to a shard's device is a no-op where the devices
are equal.

Determinism: within a shard, products add in plan order per slot; across
shards, bins add in shard order.  Both orders are fixed by the plan, so
repeated executions are bit-identical, and on integer-valued operands the
result equals the host stream (``backend="host", engine="stream"``) bit
for bit at every shard count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fast as _fast
from repro_torch.core.cost import CostConstants
from repro_torch.core.device_stream import _I32_MAX, _LIFT_LOCK, \
    StreamView, _check_batch, _operand, _view, bilinear_custom_vjp, \
    grad_replay, replay, stream_seg_ids
from repro_torch.core.executor import register_executor
from repro_torch.core.planner import Pattern, TilePlan, _pattern_csc, \
    normalize_tile_spec, plan_spgemm
from repro_torch.device import resolve_device
from repro_torch.sparse.format import CSC, _np, as_tensor
from repro_torch.sparse.partition import csc_col_slice, csc_empty, \
    csc_hstack, csc_row_slice, merge_csc_partials, nnz_balanced_col_bounds, \
    width_col_bounds
from repro_torch.sparse.stats import ops_per_column, tile_stats

# ---------------------------------------------------------------------------
# the sharded stream: every shard's replay indices (host, plan order)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardStream:
    """The product stream of a :class:`ShardedSpgemmPlan`, shard by shard.

    ``a_idx[d]``, ``b_idx[d]`` and ``seg[d]`` are shard d's replay in the
    plan's order: global positions into the whole A and B value arrays and
    the global C slot of each product (int32, host).  They equal the rows
    ``[d, :per_device[d]]`` of the reference's padded ``[D, Pmax]`` stacks.
    ``c_rows``/``c_col_ptr`` are the plan-wide output structure (host),
    shared by every result of the plan; ``padded_slots`` is the slot axis
    the shards replay into, a multiple of D with at least one slot past
    ``num_slots``.
    """

    a_idx: Tuple[np.ndarray, ...]   # D x [per_device[d]] int32 into A values
    b_idx: Tuple[np.ndarray, ...]   # D x [per_device[d]] int32 into B values
    seg: Tuple[np.ndarray, ...]     # D x [per_device[d]] int32 global C slot
    c_rows: np.ndarray              # [nnz_c] int32
    c_col_ptr: np.ndarray           # [n+1] int32
    shape: Tuple[int, int]
    n_products: int                 # all shards
    num_slots: int                  # nnz_c
    padded_slots: int               # the replay's slot axis, divisible by D
    per_device: np.ndarray          # [D] int64 products per shard

    @property
    def nbytes(self) -> int:
        """Host bytes held by the shards' index arrays."""
        return int(sum(x.nbytes for arrs in (self.a_idx, self.b_idx,
                                             self.seg) for x in arrs))


@dataclasses.dataclass(frozen=True)
class ShardViews:
    """Each shard's replays on its device: the forward replay into the
    padded slot axis, and the two gradient replays (None until the first
    backward through the plan)."""

    devices: Tuple[torch.device, ...]
    forward: Tuple[StreamView, ...]
    grad_a: Optional[Tuple[StreamView, ...]] = None
    grad_b: Optional[Tuple[StreamView, ...]] = None

    @property
    def nbytes(self) -> int:
        """Device bytes held by the views' index tensors."""
        return sum(v.nbytes for views in (self.forward, self.grad_a,
                                          self.grad_b)
                   if views is not None for v in views)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedSpgemmPlan:
    """Immutable symbolic plan for a sharded ``C = A @ B``.

    Built by :func:`plan_spgemm_mesh`; the ``backend="mesh"`` entry of the
    backend registry.  ``tiles`` are ordinary
    :class:`~repro_torch.core.planner.TilePlan` children (expand plans on
    the torch backend, shared through the plan LRU); ``device_of[i]`` is the
    shard the cost model placed ``tiles[i]`` on.  ``device`` is the one
    device every shard runs on, or ``None`` for one card a shard.  Execute
    with ``plan.execute(a, b)``, or differentiate
    ``plan.stream_apply(a_values, b_values)``.
    """

    a: Pattern
    b: Pattern
    k_bounds: np.ndarray          # [K+1] over A's columns / B's rows
    n_bounds: np.ndarray          # [N+1] over B's columns
    tiles: Tuple[TilePlan, ...]   # non-empty tiles, n-major, k-ascending
    device_of: np.ndarray         # [n_tiles] int32 shard index
    n_shards: int
    shard_limit: int              # per-shard plan-memory guard (products)
    predicted_cost: np.ndarray    # [D] float64 placed seconds per shard
    predicted_flops: np.ndarray   # [D] int64 placed flops per shard
    params: tuple
    device: Optional[torch.device] = None
    _memo: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    method = "expand"             # the canonical stream contraction
    backend = "mesh"

    @property
    def contract(self):
        from repro_torch.core import backends

        return backends.get_backend("mesh")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.a.shape[0], self.b.shape[1])

    @property
    def grid(self) -> Tuple[int, int]:
        return (len(self.k_bounds) - 1, len(self.n_bounds) - 1)

    @property
    def stream_limit(self) -> int:
        # the SpgemmPlan spelling (the guard here is per shard)
        return self.shard_limit

    @property
    def imbalance(self) -> float:
        """max/mean predicted flops across shards (1.0 = perfect)."""
        mean = float(self.predicted_flops.mean())
        if mean <= 0:
            return 1.0
        return float(self.predicted_flops.max()) / mean

    @property
    def stream(self) -> ShardStream:
        """The sharded stream (built at first use, kept on the plan)."""
        return shard_stream(self)

    @property
    def mesh_stream_nbytes(self) -> int:
        """Bytes of the sharded stream this plan holds: its host index
        arrays and, once lifted, the shards' views on their devices.  Reads
        the memo without building anything (``plan_cache_info()
        ["mesh_stream_bytes"]``); the child plans' own streams are counted
        by the other totals."""
        ss = self._memo.get("mesh")
        views = self._memo.get("views")
        return ((ss.nbytes if ss is not None else 0)
                + (views.nbytes if views is not None else 0))

    @property
    def cache_key(self) -> tuple:
        """The plan LRU's key of this plan (``core.api``)."""
        return mesh_plan_key(self.a.fingerprint, self.b.fingerprint,
                             self.params, self.device)

    def stream_apply(self, a_values, b_values):
        """Differentiable numeric phase: C's ``[nnz_c]`` values.

        ``a_values``/``b_values`` are value vectors aligned with the
        planned patterns (torch tensors, which may require grad); the
        result lies on shard 0's device, on the plan's output structure
        (``plan.stream.c_rows``/``c_col_ptr``), and ``torch.autograd``
        differentiates it with two more sharded replays.
        """
        self.a.check_compatible(a_values)
        self.b.check_compatible(b_values)
        return mesh_fn(self)(a_values, b_values)

    def execute(self, a_values, b_values, *, stats: dict | None = None,
                validate: str | None = None,
                engine: str | None = None) -> CSC:
        """Numeric phase through the executor dispatch."""
        from repro_torch.core.executor import execute

        return execute(self, a_values, b_values, stats=stats,
                       validate=validate, engine=engine)

    def execute_batched(self, a_values, b_values, *,
                        stats: dict | None = None,
                        validate: str | None = None,
                        engine: str | None = None) -> list:
        """Batched numeric phase (B same-pattern value sets)."""
        from repro_torch.core.executor import execute_batched

        return execute_batched(self, a_values, b_values, stats=stats,
                               validate=validate, engine=engine)


def mesh_plan_key(a_fp: str, b_fp: str, params: tuple, device) -> tuple:
    """The LRU key of a mesh plan, laid out as a single plan's: both
    fingerprints, ``"expand"``, ``"mesh"``, the params (the profile tag, the
    per-shard guard, the shard count and the tile spec), the guard, and
    the device (``"cards"`` for one card a shard)."""
    return (a_fp, b_fp, "expand", "mesh", params, dict(params)["shard_limit"],
            "cards" if device is None else str(device))


def resolve_shards(shards, device) -> int:
    """The shard count of a plan: ``shards``, or one a visible card (one
    on the CPU).  ``device=None`` with no card raises, as every default
    device of the port does."""
    if shards is not None:
        return int(shards)
    if device is None:
        resolve_device(None)
        return torch.cuda.device_count()
    return 1 if torch.device(device).type == "cpu" \
        else torch.cuda.device_count()


# ---------------------------------------------------------------------------
# planning: grid sizing, child plans, cost-model placement
# ---------------------------------------------------------------------------


def _ops_balanced_bounds(ops: np.ndarray, n_blocks: int) -> np.ndarray:
    """Column-block boundaries that roughly equalize predicted flops: cuts
    at the quantiles of cumulative ``Op_j`` (flops per output column), so
    column blocks carry comparable work, which is what the placement
    balances."""
    n = len(ops)
    if n == 0:
        return np.asarray([0], np.int64)
    n_blocks = max(1, min(int(n_blocks), n))
    cum = np.concatenate(([0], np.cumsum(ops, dtype=np.int64)))
    if n == 1 or n_blocks == 1:
        return np.asarray([0, n], np.int64)
    targets = np.linspace(0, cum[-1], n_blocks + 1)[1:-1]
    cuts = np.clip(np.searchsorted(cum, targets, side="left"), 1, n - 1)
    return np.unique(np.concatenate(([0], cuts, [n]))).astype(np.int64)


def _auto_bounds(a: CSC, b: CSC, n_shards: int, budget: int) -> tuple:
    """(k_bounds, n_bounds) sized so every tile's stream fits ``budget``.

    The n axis splits at flop quantiles until the largest column block
    fits (with 2x headroom for placement slack) and there are a few tiles
    a shard for LPT to balance; a single output column hotter than the
    budget then splits the k axis.
    """
    ops = ops_per_column(a, b)
    total = int(ops.sum())
    target = max(1, budget // 2)
    n_cols = b.n_cols
    want = max(min(2 * n_shards, max(n_cols, 1)), -(-total // target))
    n_bounds = _ops_balanced_bounds(ops, want)
    for _ in range(32):
        if len(n_bounds) - 1 >= n_cols or len(ops) == 0:
            break
        block = np.add.reduceat(ops, n_bounds[:-1])
        if block.max() <= budget:
            break
        want *= 2
        n_bounds = _ops_balanced_bounds(ops, want)
    hottest = int(ops.max()) if len(ops) else 0
    if hottest > budget:
        k_blocks = min(max(a.n_cols, 1), -(-hottest // target))
        k_bounds = nnz_balanced_col_bounds(a, k_blocks)
    else:
        k_bounds = np.asarray([0, a.n_cols], np.int64)
    return k_bounds, n_bounds


def plan_spgemm_mesh(
    a: CSC,
    b: CSC,
    *,
    shards: int | None = None,
    tile=None,
    shard_limit: int | None = None,
    cache: bool = True,
    constants: CostConstants | None = None,
    device=None,
) -> ShardedSpgemmPlan:
    """Build the sharded symbolic plan for ``C = A @ B``.

    ``shards``: the shard count (default: one a visible card, or one on
    the CPU).  ``device``: ``None`` runs shard d on ``cuda:d``; a device
    (``"cuda"``, ``"cuda:0"``, ``"cpu"``) runs every shard there.
    ``shard_limit``: the per-shard plan-memory guard (default
    ``fast.STREAM_MAX_PRODUCTS``); the grid is sized so every tile's stream
    fits it, so a multiply whose whole stream exceeds one device's guard
    stays plannable.  ``tile``: an explicit ``(k_width, n_width)`` grid (see
    ``normalize_tile_spec``).  ``cache=True`` routes the child plans through
    the plan LRU.  ``constants`` replaces the machine profile's for the
    placement.  Raises when the stream cannot fit ``shards x shard_limit``.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    dev = None if device is None else resolve_device(device)
    n_shards = resolve_shards(shards, dev)
    if n_shards < 1:
        raise ValueError(f"shards must be >= 1, got {n_shards}")
    limit = (_fast.STREAM_MAX_PRODUCTS if shard_limit is None
             else int(shard_limit))
    if limit < 1:
        raise ValueError(f"shard_limit must be >= 1, got {limit}")
    # constants=None ranks the placement on the machine profile, whose tag
    # joins the params (and so the LRU key)
    if constants is None:
        from repro_torch.core import profile as _profile

        prof = _profile.current_profile()
        c, profile_tag = prof.constants, prof.tag
    else:
        c, profile_tag = constants, "explicit"

    a_pat, b_pat = Pattern.of(a), Pattern.of(b)
    a0, b0 = _pattern_csc(a_pat), _pattern_csc(b_pat)
    spec = normalize_tile_spec(tile)
    k_width, n_width = spec
    auto_k, auto_n = _auto_bounds(a0, b0, n_shards, limit)
    k_bounds = (width_col_bounds(a0.n_cols, k_width) if k_width else auto_k)
    n_bounds = (width_col_bounds(b0.n_cols, n_width) if n_width else auto_n)

    # the children are planning artefacts: their host streams become the
    # shards' streams, and they never execute, so they live on the CPU
    def _child(ta, tb):
        if cache:
            from repro_torch.core.api import cached_plan

            return cached_plan(ta, tb, "expand", backend="torch",
                               device="cpu", stream_limit=limit)
        return plan_spgemm(ta, tb, "expand", backend="torch", device="cpu",
                           stream_limit=limit)

    a_tiles = [csc_col_slice(a0, int(k0), int(k1))
               for k0, k1 in zip(k_bounds[:-1], k_bounds[1:])]
    tiles: list[TilePlan] = []
    tile_flops: list[int] = []
    for ni, (j0, j1) in enumerate(zip(n_bounds[:-1], n_bounds[1:])):
        b_col, (b_lo, _) = csc_col_slice(b0, int(j0), int(j1))
        for ki, (k0, k1) in enumerate(zip(k_bounds[:-1], k_bounds[1:])):
            a_tile, (a_lo, a_hi) = a_tiles[ki]
            if a_tile.nnz == 0:
                continue
            b_tile, rel = csc_row_slice(b_col, int(k0), int(k1))
            if b_tile.nnz == 0:
                continue
            st = tile_stats(a_tile, b_tile)
            if st.flops == 0:
                continue
            if st.flops > limit:
                raise ValueError(
                    f"tile (k={ki}, n={ni}) carries {st.flops} products, "
                    f"above the per-shard guard shard_limit={limit}; "
                    "shrink tile= or raise shard_limit")
            tiles.append(TilePlan(
                k=ki, n=ni, a_vals=(a_lo, a_hi),
                b_vals=(b_lo + rel).astype(np.int64),
                plan=_child(a_tile, b_tile)))
            tile_flops.append(int(st.flops))

    # LPT placement on the torch stream's cost (dispatch + flat per-product
    # work): heaviest tile first onto the least loaded shard.  The cost is
    # affine in flops, so balancing it balances flops
    cost_of = [c.torch_base + c.torch_prod * f for f in tile_flops]
    device_of = np.zeros(len(tiles), np.int32)
    loads = np.zeros(n_shards, np.float64)
    flops_d = np.zeros(n_shards, np.int64)
    for i in sorted(range(len(tiles)), key=lambda i: -cost_of[i]):
        d = int(np.argmin(loads))
        device_of[i] = d
        loads[d] += cost_of[i]
        flops_d[d] += tile_flops[i]
    if len(tiles) and int(flops_d.max()) > limit:
        raise ValueError(
            f"placement puts {int(flops_d.max())} products on one shard, "
            f"above shard_limit={limit} (total {sum(tile_flops)} products "
            f"over {n_shards} shards); raise shards= or shard_limit=")

    params = (("profile", profile_tag), ("shard_limit", limit),
              ("shards", n_shards), ("tile", spec))
    return ShardedSpgemmPlan(
        a_pat, b_pat, np.asarray(k_bounds, np.int64),
        np.asarray(n_bounds, np.int64), tuple(tiles), device_of, n_shards,
        limit, loads, flops_d, params, dev)


# ---------------------------------------------------------------------------
# plan -> ShardStream: global structure, destination bins, shard streams
# ---------------------------------------------------------------------------


def _mesh_guard_error(plan, tile) -> ValueError:
    return ValueError(
        f"tile (k={tile.k}, n={tile.n}) of the mesh plan has no product "
        f"stream (child guard shard_limit={plan.shard_limit} tripped); "
        "replan with a higher shard_limit or a finer tile grid")


def shard_stream(plan: ShardedSpgemmPlan) -> ShardStream:
    """The plan's sharded stream, built at first use and kept on the plan.

    Three pattern-only passes, the reference's:

    1. the global structure: per column block, the tiles' child C
       structures merge in k order (``merge_csc_partials`` on zeros: the
       union only), and the blocks stitch left to right;
    2. destination binning: each tile's child slots map into the global
       slot space with one ``searchsorted`` a tile (a child's structure is
       a subsequence of its block's union);
    3. per shard, its tiles' streams concatenate in the plan's n-major,
       k-ascending order, rewritten to global A/B value positions.
    """
    memo = plan._memo
    if "mesh" in memo:
        return memo["mesh"]
    m, n = plan.shape
    D = plan.n_shards
    N = len(plan.n_bounds) - 1

    per_block: dict = {ni: [] for ni in range(N)}
    for ti, t in enumerate(plan.tiles):
        s = t.plan.stream
        if s is None:
            raise _mesh_guard_error(plan, t)
        per_block[t.n].append((ti, t, s))

    # pass 1: the global structure (per block, the k-ordered union)
    blocks = []
    for ni in range(N):
        w = int(plan.n_bounds[ni + 1] - plan.n_bounds[ni])
        parts = [CSC(as_tensor(np.zeros(s.nnz)), s.c_rows, s.c_col_ptr,
                     (m, w)) for _, _, s in per_block[ni]]
        blocks.append(merge_csc_partials(parts, (m, w))
                      if parts else csc_empty((m, w)))
    gc = csc_hstack(blocks, m) if blocks else csc_empty((m, 0))
    c_rows = np.ascontiguousarray(_np(gc.row_indices), np.int32)
    c_col_ptr = np.ascontiguousarray(_np(gc.col_ptr), np.int32)
    nnz_c = int(c_col_ptr[-1])
    block_off = np.concatenate(
        ([0], np.cumsum([blk.nnz for blk in blocks]))).astype(np.int64)

    # passes 2 and 3: each shard's global index stream, in plan order
    dev_parts: list = [[] for _ in range(D)]
    for ni in range(N):
        blk = blocks[ni]
        key_b = (np.repeat(np.arange(blk.n_cols, dtype=np.int64),
                           np.diff(_np(blk.col_ptr).astype(np.int64)))
                 * m + _np(blk.row_indices).astype(np.int64))
        for ti, t, s in per_block[ni]:
            key_t = (np.repeat(np.arange(s.shape[1], dtype=np.int64),
                               np.diff(s.c_col_ptr.astype(np.int64)))
                     * m + s.c_rows.astype(np.int64))
            slot = np.searchsorted(key_b, key_t) + block_off[ni]
            seg = slot[stream_seg_ids(s)]
            a_idx = t.a_vals[0] + s.a_pos
            b_idx = np.asarray(t.b_vals, np.int64)[s.b_pos]
            dev_parts[int(plan.device_of[ti])].append((a_idx, b_idx, seg))

    per_device = np.asarray(
        [sum(len(p[0]) for p in parts) for parts in dev_parts], np.int64)
    total = int(per_device.sum())
    p_max = max(1, int(per_device.max()) if D else 1)
    s_pad = D * -(-(nnz_c + 1) // D)      # >= 1 slot past nnz_c
    if max(plan.a.nnz, plan.b.nnz, s_pad, p_max) > _I32_MAX:
        raise ValueError(
            f"sharded stream of {total} products over operands of nnz "
            f"{plan.a.nnz}/{plan.b.nnz} exceeds int32 device indexing; "
            "lower shard_limit or shrink the tiles")

    def joined(parts, i):
        if not parts:
            return np.zeros(0, np.int32)
        return np.concatenate([p[i] for p in parts]).astype(np.int32)

    memo["mesh"] = ShardStream(
        a_idx=tuple(joined(p, 0) for p in dev_parts),
        b_idx=tuple(joined(p, 1) for p in dev_parts),
        seg=tuple(joined(p, 2) for p in dev_parts),
        c_rows=c_rows, c_col_ptr=c_col_ptr, shape=(m, n), n_products=total,
        num_slots=nnz_c, padded_slots=s_pad, per_device=per_device)
    return memo["mesh"]


# ---------------------------------------------------------------------------
# execution: per-shard replays, the shard-ordered reduction, the vjp
# ---------------------------------------------------------------------------


def shard_devices(plan: ShardedSpgemmPlan) -> tuple:
    """The device of each shard: the plan's one device, or ``cuda:d`` for
    shard d, which needs as many cards as shards."""
    if plan.device is not None:
        return (plan.device,) * plan.n_shards
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < plan.n_shards:
        raise ValueError(
            f"mesh plan needs {plan.n_shards} cards, found {have}; pass "
            "device='cuda' to run every shard on one card (or device='cpu' "
            f"on the host), or replan with shards={max(have, 1)}")
    return tuple(torch.device("cuda", d) for d in range(plan.n_shards))


def _forward_view(a_idx, b_idx, seg, s_pad, dev) -> StreamView:
    # the products stably sorted by slot: a slot's products stay in plan
    # order, and every slot of the padded axis is one segment
    order = np.argsort(seg, kind="stable")
    seg_ptr = np.zeros(s_pad + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=s_pad), out=seg_ptr[1:])
    return _view(a_idx[order], b_idx[order], seg_ptr, dev)


def shard_views(plan: ShardedSpgemmPlan, grads: bool = False) -> ShardViews:
    """Each shard's replays on its device, built at first use and kept on
    the plan; the gradient replays at the first call with ``grads=True``.
    One lift a plan, under the torch stream's lift lock."""
    ss = shard_stream(plan)
    devs = shard_devices(plan)
    memo = plan._memo
    if "views" not in memo or (grads and memo["views"].grad_a is None):
        with _LIFT_LOCK:
            if "views" not in memo:
                memo["views"] = ShardViews(devs, tuple(
                    _forward_view(ss.a_idx[d], ss.b_idx[d], ss.seg[d],
                                  ss.padded_slots, devs[d])
                    for d in range(plan.n_shards)))
            if grads and memo["views"].grad_a is None:
                ga, gb = [], []
                for d in range(plan.n_shards):
                    a_i, b_i, sg = ss.a_idx[d], ss.b_idx[d], ss.seg[d]
                    x = grad_replay(a_i, b_i, sg)
                    y = grad_replay(b_i, a_i, sg)
                    ga.append(_view(*x[:3], devs[d], out_map=x[3]))
                    gb.append(_view(*y[:3], devs[d], out_map=y[3]))
                memo["views"] = dataclasses.replace(
                    memo["views"], grad_a=tuple(ga), grad_b=tuple(gb))
    return memo["views"]


def reduce_bins(parts, devices) -> torch.Tensor:
    """The shard-ordered reduction of equal-length partials: bin d (the
    d-th of ``len(parts)`` equal slices) is every shard's bin d added left
    to right in ascending shard order on shard d's device; the bins join
    on shard 0's device.  Plan-static: no atomics, no host sync."""
    D = len(parts)
    width = parts[0].shape[-1] // D
    bins = []
    for d in range(D):
        lo, hi = d * width, (d + 1) * width
        acc = parts[0][..., lo:hi].to(devices[d])
        for e in range(1, D):
            acc = acc + parts[e][..., lo:hi].to(devices[d])
        bins.append(acc.to(devices[0]))
    return torch.cat(bins, dim=-1)


def _contract(plan: ShardedSpgemmPlan):
    """(run, fn) of a plan, each ``f(a_values, b_values) -> c_values`` on
    operands anywhere: ``run`` the forward replay alone, outside autograd;
    ``fn`` the contraction with its two gradient replays."""
    ss = shard_stream(plan)
    views = shard_views(plan)
    devs = views.devices
    D = plan.n_shards
    nnz_a, nnz_b = plan.a.nnz, plan.b.nnz
    nnz_c, s_pad = ss.num_slots, ss.padded_slots
    a_pad = D * -(-max(nnz_a, 1) // D)
    b_pad = D * -(-max(nnz_b, 1) // D)

    def _fit(cot, primal, nnz):
        # the cotangent takes the primal's (possibly oversized) length;
        # positions past nnz never entered the contraction: zero
        want = primal.shape[-1]
        cot = cot[..., :nnz]
        if want == nnz:
            return cot
        out = torch.zeros(want, dtype=cot.dtype, device=cot.device)
        out[:nnz] = cot
        return out

    if ss.n_products == 0:
        # nothing to contract: C's values are structurally zero (or empty)
        def forward(av, bv):
            return torch.zeros(nnz_c, dtype=torch.float32, device=av.device)

        def grad_a(g, av, bv):
            return torch.zeros_like(av)

        def grad_b(g, av, bv):
            return torch.zeros_like(bv)
    else:
        def forward(av, bv):
            parts = [replay(views.forward[d], av.to(devs[d]),
                            bv.to(devs[d])) for d in range(D)]
            return reduce_bins(parts, devs)[:nnz_c]

        def _grad(which, g, other, n_pad):
            gv = getattr(shard_views(plan, grads=True), which)
            parts = []
            for d in range(D):
                compact = replay(gv[d], g.to(devs[d]), other.to(devs[d]))
                out = torch.zeros(n_pad, dtype=compact.dtype,
                                  device=devs[d])
                parts.append(out.index_copy_(0, gv[d].out_map, compact))
            return reduce_bins(parts, devs)

        def grad_a(g, av, bv):
            return _fit(_grad("grad_a", g, bv, a_pad), av, nnz_a)

        def grad_b(g, av, bv):
            return _fit(_grad("grad_b", g, av, b_pad), bv, nnz_b)

    contract = bilinear_custom_vjp(forward, grad_a, grad_b)
    dev0 = devs[0]

    def run(a_values, b_values):
        with torch.no_grad():
            return forward(_operand(a_values, dev0),
                           _operand(b_values, dev0))

    def fn(a_values, b_values):
        return contract(_operand(a_values, dev0),
                        _operand(b_values, dev0))

    return run, fn


def _contract_of(plan):
    memo = plan._memo
    if "contract" not in memo:
        memo["contract"] = _contract(plan)
    return memo["contract"]


def mesh_fn(plan: ShardedSpgemmPlan):
    """The plan's differentiable function ``f(a_values, b_values) ->
    c_values``: the shards' replays reduced in shard order, C's values on
    shard 0's device.  Kept on the plan."""
    return _contract_of(plan)[1]


def _record_stats(plan, ss, stats, devs):
    if stats is None:
        return
    stats.update(engine="stream", backend="mesh",
                 device=[str(d) for d in devs], shards=plan.n_shards,
                 grid=plan.grid, stream_products=ss.n_products,
                 per_device_products=ss.per_device.tolist(),
                 imbalance=plan.imbalance, result_shape=ss.shape)


def execute_mesh(plan, a_values, b_values, *, stats: dict | None = None,
                 validate: str | None = None) -> CSC:
    """Numeric phase of a mesh plan (the executor's ``("mesh", "stream")``
    entry): the result's values on shard 0's device, on the plan's output
    structure (host arrays).  Not differentiable: use
    ``plan.stream_apply``."""
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    run, _ = _contract_of(plan)
    vals = run(a_values, b_values)
    ss = shard_stream(plan)
    _record_stats(plan, ss, stats, shard_views(plan).devices)
    return CSC(vals, ss.c_rows, ss.c_col_ptr, ss.shape)


def execute_mesh_batched(plan, a_values, b_values, *,
                         stats: dict | None = None,
                         validate: str | None = None) -> list:
    """Batched numeric phase: B value sets, one sharded execution each, as
    the reference loops (its collective does not ride ``vmap``); result b
    equals :func:`execute_mesh` on value set b bit for bit."""
    av = plan.a.batched_values(a_values, validate)
    bv = plan.b.batched_values(b_values, validate)
    batch = _check_batch(av, bv)
    run, _ = _contract_of(plan)
    ss = shard_stream(plan)
    out = [CSC(run(av[i], bv[i]), ss.c_rows, ss.c_col_ptr, ss.shape)
           for i in range(batch)]
    _record_stats(plan, ss, stats, shard_views(plan).devices)
    if stats is not None:
        stats["batch"] = batch
    return out


register_executor("mesh", "stream", execute_mesh, execute_mesh_batched)
