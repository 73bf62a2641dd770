"""The port's per-tile cost model (``repro_torch.core.cost`` over
``repro_torch.sparse.stats.tile_stats``) against the JAX package's
(``repro.core.cost``), on random, power-law and Table-1-shaped tiles built
with numpy from a seed: ``tile_stats`` equal field for field,
``estimate_cost`` equal float for float for every candidate of every
backend, and ``choose_method`` equal; then the model's regimes, mirrored
from ``tests/test_tiled.py``.  The port's backends are the reference's
under their port names: ``cuda`` is ``pallas``, ``torch`` is ``jax``, and
the ``"torch"`` candidate is ``"jax"``.

The reference ranks on its machine profile when one is persisted;
``tests/conftest.py`` pins its profile directory to an empty path, so here
it ranks on its defaults, as the port always does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.cost as ref_cost
from repro.sparse.stats import tile_stats as ref_tile_stats
from repro_torch.core import backend_names, cost, fast
from repro_torch.core.planner import ALGORITHMS
from repro_torch.sparse import generate, synthesize_suitesparse
from repro_torch.sparse.format import CSC, csc_from_dense
from repro_torch.sparse.partition import csc_col_slice, csc_row_slice
from repro_torch.sparse.stats import TileStats, tile_stats
from torch_parity import to_ref

REF_BACKEND = {"cuda": "pallas", "torch": "jax", "host": "host"}
# every method either cost domain ranks, in the port's spelling
METHODS = ("spa", "expand", "esc", "torch", "fused", "spars-16/64",
           "spars-40/40", "h-spa-16/64", "h-spa-40/40", "hash-32/256",
           "hash-256/256", "h-hash-32/256", "h-hash-256/256",
           "spars-128/128")


def _ref_name(method):
    return "jax" if method == "torch" else method


def _tile_pairs():
    """(name, a, b) tile operand pairs: random, power-law, dense-ish,
    rectangular, and tiles of Table-1 matrices cut as a tile=(1024, 1024)
    grid cuts them."""
    out = []
    for seed in range(3):
        a = generate.random_powerlaw_csc(64, 1.5 + seed, seed=25 + seed)
        out.append((f"powerlaw{seed}", a, a))
        out.append((f"uniform{seed}",
                    generate.random_uniform_csc(48, 2 + 2 * seed, seed=seed),
                    generate.random_uniform_csc(48, 3, seed=seed + 10)))
    rng = np.random.default_rng(24)
    out.append(("dense", csc_from_dense(rng.uniform(0.5, 1.5, (64, 64))),
                csc_from_dense((rng.uniform(size=(64, 8)) < 0.5)
                               * rng.uniform(size=(64, 8)))))
    out.append(("rect", generate.random_density_csc(18, 30, 0.12, seed=1),
                generate.random_density_csc(30, 11, 0.2, seed=2)))
    for name in ("tols1090", "cage9", "iprob"):
        m, _ = synthesize_suitesparse(name, seed=0)
        n = m.n_cols
        for k0, j0 in ((0, 0), (1024, 0), (0, 2048)):
            k1, j1 = min(k0 + 1024, n), min(j0 + 1024, n)
            if k0 >= n or j0 >= n:
                continue
            at, _ = csc_col_slice(m, k0, k1)
            bc, _ = csc_col_slice(m, j0, j1)
            bt, _ = csc_row_slice(bc, k0, k1)
            out.append((f"{name}[{k0},{j0}]", at, bt))
    return out


PAIRS = _tile_pairs()


@pytest.mark.parametrize("name,a,b", PAIRS, ids=[p[0] for p in PAIRS])
def test_tile_stats_equal_reference_field_for_field(name, a, b):
    got = tile_stats(a, b)
    want = ref_tile_stats(to_ref(a), to_ref(b))
    for f in dataclasses.fields(TileStats):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    assert got.flops == want.flops


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
@pytest.mark.parametrize("name,a,b", PAIRS, ids=[p[0] for p in PAIRS])
def test_estimate_cost_and_choice_equal_reference(name, a, b, backend):
    stats = tile_stats(a, b)
    rstats = ref_tile_stats(to_ref(a), to_ref(b))
    rb = REF_BACKEND[backend]
    for method in METHODS:
        try:
            want = ref_cost.estimate_cost(rstats, _ref_name(method), rb,
                                          ref_cost.DEFAULT_CONSTANTS)
        except ValueError:
            with pytest.raises(ValueError):
                cost.estimate_cost(stats, method, backend)
            continue
        got = cost.estimate_cost(stats, method, backend)
        assert got == want, (method, got, want)
    cands = cost.AUTO_CANDIDATES[backend]
    want = ref_cost.choose_method(
        rstats, rb, tuple(_ref_name(c) for c in
                          ref_cost.AUTO_CANDIDATES[rb]),
        ref_cost.DEFAULT_CONSTANTS)
    assert cost.choose_method(stats, backend) == \
        ("torch" if want == "jax" else want)
    assert tuple(_ref_name(c) for c in cands) == ref_cost.AUTO_CANDIDATES[rb]


def test_constants_are_the_references_defaults():
    ref_fields = dataclasses.asdict(ref_cost.DEFAULT_CONSTANTS)
    mine = dataclasses.asdict(cost.DEFAULT_CONSTANTS)
    for key, value in mine.items():
        assert ref_fields[key.replace("torch_", "jax_")] == value, key
    # the mesh's comm terms too: every field has its counterpart
    assert set(ref_fields) == {k.replace("torch_", "jax_") for k in mine}


def test_explicit_constants_change_the_choice_as_in_the_reference():
    a = generate.random_powerlaw_csc(64, 3.0, seed=5)
    stats, rstats = tile_stats(a, a), ref_tile_stats(to_ref(a), to_ref(a))
    # a torch stream priced below the numpy one wins the host grid
    mine = dataclasses.replace(cost.DEFAULT_CONSTANTS, torch_prod=1e-12,
                               torch_base=1e-9)
    theirs = dataclasses.replace(ref_cost.DEFAULT_CONSTANTS, jax_prod=1e-12,
                                 jax_base=1e-9)
    assert cost.choose_method(stats, "host", constants=mine) == "torch"
    assert ref_cost.choose_method(rstats, "host", constants=theirs) == "jax"
    for m in cost.AUTO_CANDIDATES["host"]:
        assert cost.estimate_cost(stats, m, "host", mine) == \
            ref_cost.estimate_cost(rstats, _ref_name(m), "host", theirs)


# --- regimes (tests/test_tiled.py) -----------------------------------------


def _dense_tile_stats():
    rng = np.random.default_rng(24)
    a = csc_from_dense(rng.uniform(0.5, 1.5, size=(64, 64)))
    b = csc_from_dense(
        (rng.uniform(size=(64, 8)) < 0.5) * rng.uniform(size=(64, 8)))
    return tile_stats(a, b)


def _sparse_tile_stats():
    a = generate.random_powerlaw_csc(64, 1.5, seed=25)
    b = generate.random_powerlaw_csc(64, 1.5, seed=26)
    return tile_stats(a, b)


def _guard_tripped_tile_stats():
    """A tile whose product stream exceeds the plan-memory guard (pattern
    built directly: the model never reads values)."""
    k, nb, per = 64, 8, 32
    m = fast.STREAM_MAX_PRODUCTS // (nb * per) + 1
    a = CSC(torch.zeros(0), np.tile(np.arange(m, dtype=np.int32), k),
            np.arange(k + 1, dtype=np.int32) * m, (m, k))
    rng = np.random.default_rng(29)
    b_rows = np.concatenate(
        [np.sort(rng.choice(k, size=per, replace=False)) for _ in range(nb)])
    b = CSC(torch.zeros(0), b_rows.astype(np.int32),
            np.arange(nb + 1, dtype=np.int32) * per, (k, nb))
    return tile_stats(a, b)


def test_cost_model_host_regimes():
    # within the guard the numpy stream ("expand") wins every host tile...
    assert cost.choose_method(_dense_tile_stats(), "host") == "expand"
    assert cost.choose_method(_sparse_tile_stats(), "host") == "expand"
    # ...above it every call rebuilds the stream, and SPA wins back the
    # flop-heavy tiles
    st = _guard_tripped_tile_stats()
    assert st.flops > fast.STREAM_MAX_PRODUCTS
    assert cost.choose_method(st, "host") == "spa"


def test_cost_model_cuda_regimes():
    # dense tiles keep the [m, L] accumulator busy -> SPA; sparse tiles
    # favour the small-H hash tables (the paper's crossover)
    assert cost.choose_method(_dense_tile_stats(), "cuda") == "spa"
    sp = _sparse_tile_stats()
    assert cost.choose_method(sp, "cuda") in ("hash-256/256", "spars-40/40")
    assert (cost.estimate_cost(sp, "hash-256/256", "cuda")
            < cost.estimate_cost(sp, "spa", "cuda"))


def test_cost_model_torch_regime_on_the_defaults():
    # the copied constants put the torch stream ahead of K1 on every
    # in-guard tile (measured on a CPU container; the card ranks them the
    # other way, which calibration has to fix)
    for st in (_dense_tile_stats(), _sparse_tile_stats()):
        assert cost.choose_method(st, "torch") == "torch"


def test_cost_model_monotone_in_flops():
    small, big = _sparse_tile_stats(), _dense_tile_stats()
    for method in ("spa", "expand", "torch", "fused"):
        assert (cost.estimate_cost(big, method, "host")
                > cost.estimate_cost(small, method, "host"))


def test_cost_model_candidate_restriction_and_errors():
    st = _sparse_tile_stats()
    assert cost.choose_method(st, "host", candidates=("spa",)) == "spa"
    with pytest.raises(ValueError):
        cost.choose_method(st, "host", candidates=())
    for method in ("expand", "torch", "fused", "esc"):
        with pytest.raises(ValueError, match="no cuda kernel family"):
            cost.estimate_cost(st, method, "cuda")
    for name in ("bogus", "jax", "pallas"):
        with pytest.raises(ValueError, match="does not know"):
            cost.estimate_cost(st, name, "host")
    with pytest.raises(ValueError, match="unknown backend"):
        cost.estimate_cost(st, "spa", "pallas")


def test_auto_candidates_are_valid_methods():
    assert sorted(cost.AUTO_CANDIDATES) == sorted(backend_names())
    for backend, cands in cost.AUTO_CANDIDATES.items():
        for m in cands:
            assert (m in ALGORITHMS or m in ("torch", "fused")
                    or m.startswith(("spars", "hash", "h-")))


def test_lockstep_rounds_and_next_pow2_equal_reference():
    rng = np.random.default_rng(3)
    for b in (1, 7, 40, 256):
        steps = rng.integers(0, 50, size=300)
        assert cost._lockstep_rounds(steps, b) == \
            ref_cost._lockstep_rounds(steps, b)
    for x in (0, 1, 2, 3, 17, 1024, 1025):
        assert cost._next_pow2(x) == ref_cost._next_pow2(x)
