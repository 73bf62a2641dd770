"""The port's vector-machine model (``repro_torch.vm``) against the JAX
package's (``repro.vm``), and the paper's qualitative claims on it.

``vm/`` is host numpy with no device work, so the port must equal the
reference bit for bit: every trace's instruction counts and lane tallies,
and every machine's seconds, on ``random_uniform_csc(640, z)`` for z = 2, 6
and 10, and on the Table-1 matrix ``oscil_dcop_30`` through
``benchmarks/torch_table1.py``'s ``build_trace``/``price`` against
``benchmarks/common.py``'s.  The claims are ``tests/test_costmodel.py``'s
ten tests on the port, and ``_ws_makespan``'s list-scheduling bound from
``tests/test_spgemm_algorithms.py``.  About 15 s.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.vm as ref_vm  # noqa: E402
import repro.vm.machine as ref_machine  # noqa: E402
import repro.vm.schedule as ref_schedule  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.sparse import random_uniform_csc as ref_uniform  # noqa: E402
from repro.sparse.format import CSC as RefCSC  # noqa: E402

from repro_torch.core import preprocess  # noqa: E402
from repro_torch.sparse import ops_per_column, random_uniform_csc  # noqa: E402
from repro_torch.sparse.format import _np  # noqa: E402
from repro_torch.vm import (  # noqa: E402
    DEFAULT_MACHINE,
    Trace,
    c_column_nnz,
    trace_esc,
    trace_hash,
    trace_hybrid,
    trace_spa,
    trace_spars,
)
from repro_torch.vm import machine as port_machine  # noqa: E402
from repro_torch.vm import schedule as port_schedule  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mats():
    return {z: random_uniform_csc(640, z, seed=z) for z in (2, 6, 10)}


# --- tests/test_costmodel.py on the port ------------------------------------


def test_trace_utilization_bounds(mats):
    a = mats[2]
    pre = preprocess(a, a, t=np.inf, b_min=40, b_max=40)
    for tr in (trace_spa(a, a), trace_spars(a, a, pre),
               trace_hash(a, a, pre), trace_esc(a, a)):
        assert 0.0 < tr.utilization <= 1.0


def test_spa_active_elements_cover_products(mats):
    """SPA's main-loop FMA lanes == total intermediate products."""
    a = mats[2]
    tr = Trace()
    trace_spa(a, a, trace=tr)
    ops_total = ops_per_column(a, a).sum()
    fma = sum(c * vl for (k, vl, _), c in tr.counts.items() if k == "vfma")
    assert fma == ops_total


def test_spars_processes_blocks_of_equal_load(mats):
    """Uniform Z: every block runs exactly Z^2 steps at full occupancy."""
    a = mats[2]
    pre = preprocess(a, a, t=np.inf, b_min=40, b_max=40)
    tr = trace_spars(a, a, pre)
    assert tr.utilization > 0.99  # no masking when loads are equal


def test_machine_monotone_in_working_set():
    m = DEFAULT_MACHINE
    c_small = m.instr_cycles("vload_idx", 256, 16 << 10)
    c_large = m.instr_cycles("vload_idx", 256, 64 << 20)
    assert c_large > c_small
    assert m.instr_cycles("vload", 256, 0) < c_small


def test_machine_longer_vectors_amortize_issue():
    m = DEFAULT_MACHINE
    per_elem_short = m.instr_cycles("vfma", 8, 0) / 8
    per_elem_long = m.instr_cycles("vfma", 256, 0) / 256
    assert per_elem_long < per_elem_short


def test_paper_claim_spars_wins_sparse_loses_dense(mats):
    """Fig 3: SPARS (b=40) beats SPA for Z=2, loses for Z=10."""
    m = DEFAULT_MACHINE
    for z, expect_faster in ((2, True), (10, False)):
        a = mats[z]
        cn = c_column_nnz(a, a)
        t_spa = m.seconds(trace_spa(a, a, c_nnz=cn))
        pre = preprocess(a, a, t=np.inf, b_min=40, b_max=40)
        t_spars = m.seconds(trace_spars(a, a, pre, c_nnz=cn))
        assert (t_spars < t_spa) == expect_faster, (z, t_spars, t_spa)


def test_paper_claim_spars_bmax_peak(mats):
    """Fig 3: SPARS degrades past b_max ~ 40 (accumulator leaves L2)."""
    a = mats[2]
    cn = c_column_nnz(a, a)
    m = DEFAULT_MACHINE

    def t(bmax):
        pre = preprocess(a, a, t=np.inf, b_min=bmax, b_max=bmax)
        return m.seconds(trace_spars(a, a, pre, c_nnz=cn))

    assert t(40) < t(8)     # longer vectors help at first
    assert t(40) < t(256)   # then the accumulator range penalty dominates


def test_paper_claim_hash_likes_large_blocks(mats):
    """Fig 4: HASH keeps improving to b_max = 256 (small tables stay local)."""
    a = mats[2]
    cn = c_column_nnz(a, a)
    m = DEFAULT_MACHINE

    def t(bmax):
        pre = preprocess(a, a, t=np.inf, b_min=bmax, b_max=bmax)
        return m.seconds(trace_hash(a, a, pre, c_nnz=cn))

    assert t(256) < t(40) < t(8)


def test_paper_claim_hybrid_never_much_worse_than_spa(mats):
    """Table 1: H-* saturates at ~1.0x for dense matrices (switches to SPA)."""
    a = mats[10]
    cn = c_column_nnz(a, a)
    m = DEFAULT_MACHINE
    t_spa = m.seconds(trace_spa(a, a, c_nnz=cn))
    pre = preprocess(a, a, t=40.0, b_min=256, b_max=256)
    t_h = m.seconds(trace_hybrid(a, a, pre, accumulator="hash", c_nnz=cn))
    assert t_h <= t_spa * 1.05


def test_calibrated_machine_loaded():
    assert DEFAULT_MACHINE.issue != port_machine.Machine.__dataclass_fields__[
        "issue"].default or DEFAULT_MACHINE.beat_idx != 8.0


# --- tests/test_spgemm_algorithms.py's lane-refill bound ---------------------


def test_work_stealing_makespan_bound():
    """List-scheduling bound: steps <= ceil(P/L) + max_op."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        ops = np.sort(rng.integers(1, 100, size=64))[::-1]
        L = 16
        steps, mean_active, refills = port_schedule._ws_makespan(ops, L)
        assert steps <= -(-int(ops.sum()) // L) + int(ops.max())
        assert steps >= -(-int(ops.sum()) // L)
        assert refills == len(ops)
        assert 0 < mean_active <= L
        assert (steps, mean_active, refills) == \
            ref_schedule._ws_makespan(ops, L)


# --- bit for bit against repro.vm ---------------------------------------------


def _ref_csc(m):
    """The reference's CSC of the port's matrix (same structure, f64)."""
    return RefCSC(_np(m.values).astype(np.float64),
                  _np(m.row_indices).astype(np.int32),
                  _np(m.col_ptr).astype(np.int32), m.shape)


def _same_trace(got, want):
    assert dict(got.counts) == dict(want.counts)
    assert got.active_elems == want.active_elems
    assert got.total_elems == want.total_elems


def test_default_machine_is_the_references_fit():
    want = ref_machine.Machine(**ref_machine.CALIBRATED)
    assert dataclasses.asdict(DEFAULT_MACHINE) == dataclasses.asdict(want)
    assert port_machine.CALIBRATED == ref_machine.CALIBRATED


def test_uniform_matrices_are_the_references(mats):
    for z, a in mats.items():
        r = ref_uniform(640, z, seed=z)
        assert np.array_equal(_np(a.col_ptr), r.col_ptr)
        assert np.array_equal(_np(a.row_indices), r.row_indices)


TRACERS = {
    "spa": lambda vm, a, pre, cn: vm.trace_spa(a, a, c_nnz=cn),
    "spa_head": lambda vm, a, pre, cn: vm.trace_spa(
        a, a, columns=pre.perm[: max(pre.split, 7)], c_nnz=cn),
    "spars": lambda vm, a, pre, cn: vm.trace_spars(a, a, pre, c_nnz=cn),
    "hash": lambda vm, a, pre, cn: vm.trace_hash(a, a, pre, c_nnz=cn),
    "esc": lambda vm, a, pre, cn: vm.trace_esc(a, a),
    "esc_grouped": lambda vm, a, pre, cn: vm.trace_esc(
        a, a, group_threshold=500),
    "hybrid_spa": lambda vm, a, pre, cn: vm.trace_hybrid(
        a, a, pre, accumulator="spa", c_nnz=cn),
    "hybrid_hash": lambda vm, a, pre, cn: vm.trace_hybrid(
        a, a, pre, accumulator="hash", c_nnz=cn),
    "preprocess": lambda vm, a, pre, cn: vm.trace_preprocess(a, a),
    "spars_ws": lambda vm, a, pre, cn: vm.trace_spars_ws(a, a, pre,
                                                         c_nnz=cn),
    "hash_ws": lambda vm, a, pre, cn: vm.trace_hash_ws(a, a, pre, c_nnz=cn),
    "hybrid_ws": lambda vm, a, pre, cn: vm.trace_hybrid_ws(
        a, a, pre, accumulator="hash", c_nnz=cn),
    "hybrid_ws_spa": lambda vm, a, pre, cn: vm.trace_hybrid_ws(
        a, a, pre, accumulator="spa", c_nnz=cn),
}


@pytest.mark.parametrize("z", (2, 6, 10))
@pytest.mark.parametrize("tracer", sorted(TRACERS))
def test_traces_and_seconds_equal_the_references(mats, z, tracer):
    """Counts, lane tallies and machine seconds bit for bit, under the
    fitted machine and a machine with every constant moved."""
    a = mats[z]
    ra = _ref_csc(a)
    # a hybrid split inside the matrix and blocks of 16-64 lanes
    pre = preprocess(a, a, t=float(z * z), b_min=16, b_max=64)
    rpre = ref_preprocess(ra, ra, t=float(z * z), b_min=16, b_max=64)
    cn = c_column_nnz(a, a)
    assert np.array_equal(cn, ref_vm.c_column_nnz(ra, ra))
    got = TRACERS[tracer](port_schedule, a, pre, cn)
    want = TRACERS[tracer](ref_schedule, ra, rpre, cn)
    _same_trace(got, want)
    other = dict(issue=7.5, beat_idx=3.25, miss_penalty=2.5, lanes=4,
                 l2_bytes=float(1 << 16), scalar_cpi=2.0)
    for mine, theirs in (
            (DEFAULT_MACHINE, ref_machine.Machine(**ref_machine.CALIBRATED)),
            (DEFAULT_MACHINE.replace(**other),
             ref_machine.Machine(**{**ref_machine.CALIBRATED, **other}))):
        assert mine.cycles(got) == theirs.cycles(want)
        assert mine.seconds(got) == theirs.seconds(want)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # its dataclass resolves annotations there
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    """``benchmarks/torch_table1.py`` and the reference's
    ``benchmarks/common.py`` (which imports ``repro``)."""
    sys.path.insert(0, REPO)
    try:
        import benchmarks.common as common
    finally:
        sys.path.remove(REPO)
    port = _load("torch_table1_under_test",
                 os.path.join(REPO, "benchmarks", "torch_table1.py"))
    return port, common


@pytest.fixture(scope="module")
def oscil():
    from repro_torch.sparse.suitesparse import synthesize_suitesparse

    m, _ = synthesize_suitesparse("oscil_dcop_30", seed=0)
    return m


def test_table1_algorithm_lists_are_the_references(benches):
    port, common = benches
    assert port.PAPER_ALGOS == common.PAPER_ALGOS
    for name in ("spa", "esc", "hash-sota") + port.PAPER_ALGOS:
        assert dataclasses.asdict(port.algo_spec(name)) == \
            dataclasses.asdict(common.algo_spec(name))


@pytest.mark.parametrize("algo", ("spa", "hash-sota", "spars-16/64",
                                  "spars-40/40", "h-spa-16/64",
                                  "h-spa-40/40", "hash-32/256",
                                  "hash-256/256", "h-hash-32/256",
                                  "h-hash-256/256", "esc"))
def test_table1_trace_and_price_equal_the_references(benches, oscil, algo):
    """``oscil_dcop_30`` through both benchmarks' ``build_trace``,
    ``trace_arrays`` and ``price``: equal arrays, equal seconds, and the
    vectorized price equal to ``Machine.seconds``."""
    port, common = benches
    got = port.build_trace(oscil, oscil, algo)
    ref = _ref_csc(oscil)
    want = common.build_trace(ref, ref, algo)
    _same_trace(got, want)
    ga, wa = port.trace_arrays(got), common.trace_arrays(want)
    for x, y in zip(ga, wa):
        assert np.array_equal(x, y)
    mach = ref_machine.Machine(**ref_machine.CALIBRATED)
    assert port.price(ga, DEFAULT_MACHINE) == common.price(wa, mach)
    assert port.price(ga, DEFAULT_MACHINE) == pytest.approx(
        DEFAULT_MACHINE.seconds(got), rel=1e-12)


def test_table1_run_on_cached_traces(benches, oscil, tmp_path, monkeypatch):
    """``run()`` prices every matrix from its trace cache: with every entry
    made from ``oscil_dcop_30`` it prints the CSV's rows and averages."""
    port, _ = benches
    monkeypatch.setattr(port, "CACHE", str(tmp_path))
    entry = {name: port.trace_arrays(port.build_trace(oscil, oscil, name))
             for name in ("spa", "hash-sota") + port.PAPER_ALGOS}
    os.makedirs(tmp_path / "traces")
    import pickle

    for spec in port.SUITESPARSE_TABLE1:
        with open(tmp_path / "traces" / f"{spec.name}_s0.pkl", "wb") as f:
            pickle.dump(entry, f)
    out = port.run(csv=False)
    t_spa = port.price(entry["spa"], DEFAULT_MACHINE)
    want = [t_spa / port.price(entry[a], DEFAULT_MACHINE)
            for a in port.PAPER_ALGOS]
    np.testing.assert_allclose(out["avg"], want, rtol=1e-12)
    np.testing.assert_allclose(out["avg22"], want, rtol=1e-12)
