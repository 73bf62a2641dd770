"""Analytical per-tile cost model for ``method="auto"`` (the port's copy of
the JAX package's ``repro/core/cost.py``, without its mesh functions).

Each tile of a :class:`~repro_torch.core.planner.TiledSpgemmPlan` gets the
method the model predicts cheapest for that tile's work profile: the
paper's per-column hybrid switching generalized to per-tile method
selection.  Two models, selected by the backend's ``cost_domain``:

* **seconds** (``host`` and ``torch``): predicted wall time.  SPA pays a
  per-column and per-B-entry loop toll but touches each product once;
  ``expand`` replays the plan's product stream (a flat per-product cost)
  while the stream fits the plan-memory guard, and rebuilds it on every
  call above it; the lock-step executors pay an iteration per round; the
  ``"torch"`` candidate (the torch stream, the reference's ``"jax"``) and
  ``"fused"`` (K1) pay a dispatch and a flat per-product cost.
* **relative** (``cuda``): kernel work from the paper's cost dictionary.
  SPA streams every B entry against an ``[m, L]`` tile, SPARS pays the
  block-max trip count against the same tile, HASH pays it against an
  ``[H, L]`` table with ``H`` sized from the block's worst column, so
  sparse tiles favour HASH and dense tiles SPA: the paper's crossover.

The constants are the JAX package's defaults, copied unchanged, so that the
port's per-tile choices equal the reference's tile for tile.  They were
measured on a CPU container: on the H100 they rank the engines wrongly (they
put the torch stream ahead of K1, which the card runs 1.5-82x faster).
Calibrating them for the card is the machine profile's work, which the port
does not have yet; until then every plan ranks on :data:`DEFAULT_CONSTANTS`
or on constants the caller passes.  The model reads only
:class:`~repro_torch.sparse.stats.TileStats` (pattern statistics, O(nnz));
it never looks at values.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import backends, fast
from repro_torch.sparse.stats import TileStats

# default per-backend candidate sets for method="auto", one entry per
# registered backend.  Host: the numpy engines with complementary regimes
# (expand: the plan-resident product stream; SPA: no plan-resident state,
# wins guard-tripped flop-heavy tiles), and the device engines riding the
# grid ("torch": the torch stream; "fused": K1).  Cuda: the paper's
# families, dense-tile SPA vs small-table HASH with SPARS between.  Torch:
# the torch stream and its K1 lowering.
AUTO_CANDIDATES = {
    "host": ("spa", "expand", "torch", "fused"),
    "cuda": ("spa", "spars-40/40", "hash-256/256"),
    "torch": ("torch", "fused"),
}


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Coefficients of the model (seconds-domain entries in seconds; the
    ``p_*`` entries relative).  The values are the JAX package's defaults
    (measured there on a CPU container); ``torch_*`` are its ``jax_*``."""

    # host spa: per-column loop + per-B-entry vector op + per product
    spa_col: float = 3.0e-6
    spa_entry: float = 6.7e-6
    spa_flop: float = 1.0e-8
    # host stream engine (core/fast.py): fixed call overhead + flat
    # per-product gather/multiply/segment-reduce cost (plan-resident stream)
    stream_base: float = 5.9e-6
    stream_prod: float = 6.6e-9
    # guard-tripped expand: per-call transient stream rebuild (expansion +
    # lexsort) on top of the per-product stream work
    expand_base: float = 1.0e-4
    expand_prod: float = 1.5e-7
    expand_sort: float = 8.0e-9       # per product per log2(products)
    # torch stream (core/device_stream.py): fixed dispatch + flat
    # per-product device cost
    torch_base: float = 1.4e-5
    torch_prod: float = 3.7e-8
    # K1 (core/fused_stream.py): one launch for the whole numeric phase
    fused_base: float = 7.9e-5
    fused_prod: float = 3.0e-7
    # host esc: expand + explicit LSD radix rounds
    esc_base: float = 2.0e-4
    esc_round: float = 1.2e-7         # per product per radix round
    # host lock-step executors: per Python round + per product probe work
    lockstep_iter: float = 3.0e-5
    hash_probe: float = 3.0e-6
    # cuda relative-work coefficients (unitless; compared per backend)
    p_spa_entry: float = 1.0          # x m per streamed B entry
    p_spa_col: float = 1.0            # x m per output column (tile init)
    p_lock_iter: float = 1.0          # x accumulator height per round
    p_hash_col: float = 1.0           # x H per column (compaction)


DEFAULT_CONSTANTS = CostConstants()


def _resolve_constants(constants: CostConstants | None) -> CostConstants:
    """Explicit constants win; otherwise the defaults (the port has no
    machine profile to consult yet)."""
    return DEFAULT_CONSTANTS if constants is None else constants


def _family(method: str) -> str:
    if method in ("spa", "expand", "esc", "torch", "fused"):
        return method
    if method.startswith("h-"):
        return "hybrid"
    if method.startswith("spars"):
        return "spars"
    if method.startswith("hash"):
        return "hash"
    raise ValueError(f"cost model does not know method {method!r}")


def _params(method: str) -> dict:
    from repro_torch.core.planner import resolve_params

    return resolve_params(method)


def _lockstep_rounds(steps: np.ndarray, b: int) -> int:
    """Total lock-step iterations: sum of per-block max trip counts.

    Columns run sorted by load in blocks of ~``b`` lanes and every round
    runs until the block's slowest lane finishes, so the bound is the sum of
    block maxima over the descending-sorted step counts.
    """
    work = np.sort(steps[steps > 0])[::-1]
    if not len(work):
        return 0
    return int(work[::max(int(b), 1)].sum())


def _next_pow2(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 2)))), 1)


def _guarded_rebuild_cost(flops: int, c: CostConstants) -> float:
    """Per-call transient stream rebuild (expansion + lexsort): what any
    stream engine costs above the plan-memory guard."""
    return c.expand_base + flops * (
        c.expand_prod + c.expand_sort * math.log2(max(flops, 2)))


def _stream_cost(flops: int, base: float, prod: float,
                 c: CostConstants) -> float:
    """A stream engine's cost: its dispatch and flat per-product cost while
    the stream fits the guard, the transient rebuild's above it."""
    if flops <= fast.STREAM_MAX_PRODUCTS:
        return base + prod * flops
    return _guarded_rebuild_cost(flops, c)


def _host_cost(stats: TileStats, method: str, c: CostConstants) -> float:
    fam = _family(method)
    flops = stats.flops
    if fam == "spa":
        return (c.spa_col * stats.n + c.spa_entry * stats.nnz_b
                + c.spa_flop * flops)
    if fam == "expand":
        return _stream_cost(flops, c.stream_base, c.stream_prod, c)
    if fam == "torch":
        return _stream_cost(flops, c.torch_base, c.torch_prod, c)
    if fam == "fused":
        return _stream_cost(flops, c.fused_base, c.fused_prod, c)
    if fam == "esc":
        rounds = (math.ceil(math.log2(max(stats.m, 2)) / 5)
                  + math.ceil(math.log2(max(stats.n, 2)) / 5))
        return c.esc_base + c.esc_round * flops * rounds
    params = _params(method)
    t = params.get("t", np.inf)
    head = stats.ops >= t
    tail_steps = stats.steps[~head]
    cost = (c.spa_col * int(head.sum())
            + c.spa_flop * int(stats.ops[head].sum())
            + c.spa_entry * int(head.sum()) * stats.nnz_b
            / max(stats.n, 1))
    rounds = _lockstep_rounds(tail_steps, params.get("b_max", 256))
    cost += c.lockstep_iter * rounds
    if fam == "hash" or params.get("accumulator") == "hash":
        cost += c.hash_probe * int(stats.ops[~head].sum())
    return cost


def _kernel_cost(stats: TileStats, method: str, c: CostConstants) -> float:
    fam = _family(method)
    m = max(stats.m, 1)
    if fam in ("expand", "esc", "torch", "fused"):
        # "fused" is an engine on cuda plans, not a per-group kernel family
        # the relative-work model ranks: it never competes in a cuda grid
        raise ValueError(f"method {method!r} has no cuda kernel family")
    if fam == "spa":
        return c.p_spa_entry * m * stats.nnz_b + c.p_spa_col * m * stats.n
    params = _params(method)
    t = params.get("t", np.inf)
    head = stats.ops >= t
    cost = (c.p_spa_entry * m * stats.nnz_b * int(head.sum())
            / max(stats.n, 1) + c.p_spa_col * m * int(head.sum()))
    tail_steps = stats.steps[~head]
    rounds = _lockstep_rounds(tail_steps, params.get("b_max", 256))
    acc = params.get("accumulator",
                     "hash" if fam == "hash" else "spa")
    if fam == "spars" or acc == "spa":
        cost += c.p_lock_iter * m * rounds
    else:
        tail_ops = stats.ops[~head]
        h = _next_pow2(int(tail_ops.max()) if len(tail_ops) else 2)
        cost += (c.p_lock_iter * h * rounds
                 + c.p_hash_col * h * int((~head).sum()))
    return cost


def estimate_cost(stats: TileStats, method: str, backend: str = "cuda",
                  constants: CostConstants | None = None) -> float:
    """Predicted cost of running ``method`` on one tile (lower is better).

    The model follows the backend's ``cost_domain``: host and torch
    estimates are wall seconds (so a host grid can rank its numpy tiles
    against the device engines), cuda estimates relative work units.  Only
    compare estimates within one cost domain.  ``constants=None`` is
    :data:`DEFAULT_CONSTANTS`.
    """
    c = _resolve_constants(constants)
    if backends.get_backend(backend).cost_domain == "relative":
        return _kernel_cost(stats, method, c)
    return _host_cost(stats, method, c)


def check_candidates(contract, candidates) -> tuple:
    """The candidate set of an auto plan on ``contract``'s backend: its
    default for ``None``, else the given methods, each one the model knows
    and the backend can run."""
    cands = AUTO_CANDIDATES[contract.name] if candidates is None \
        else tuple(candidates)
    if not cands:
        raise ValueError("empty candidate set")
    bad = [m for m in cands if m in contract.excluded_methods]
    if bad:
        raise ValueError(
            f"candidates {bad} have no {contract.name} kernel family "
            "(host-only)")
    for m in cands:
        _family(m)
    return cands


def choose_method(stats: TileStats, backend: str = "cuda",
                  candidates: tuple | None = None,
                  constants: CostConstants | None = None) -> str:
    """Cheapest candidate method for this tile (deterministic: the first
    wins ties in candidate order)."""
    cands = AUTO_CANDIDATES[backend] if candidates is None \
        else tuple(candidates)
    if not cands:
        raise ValueError("empty candidate set")
    c = _resolve_constants(constants)
    best, best_cost = cands[0], None
    for m in cands:
        cost = estimate_cost(stats, m, backend, c)
        if best_cost is None or cost < best_cost:
            best, best_cost = m, cost
    return best
