"""Offline stand-ins for the paper's 40 SuiteSparse matrices (Table 1).

The SuiteSparse collection is not downloaded: we encode the *published
per-matrix statistics* from Table 1 (size, NNZ, min/max/avg/var of
nnz-per-column, min/max/avg/var of multiplications-per-column for C = A·A)
and synthesize matrices that match them:

1. exact n, NNZ, min/max column degree, column-degree variance (iterative
   pairwise-transfer repair on the degree sequence);
2. approximate multiplications-per-column stats via a degree-weighted row-
   sampling exponent beta fitted so that E[deg(row)] per stored element matches
   ``mult_avg / nnz_avg`` (assortativity tuning).

The algorithm is the JAX package's; the seed salt differs (:func:`name_seed`,
a CRC of the name), so a given seed yields the same matrix in every process.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.sparse.format import CSC, _np, csc_from_numpy
from repro_torch.sparse.stats import MatrixStats, matrix_stats


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    n: int
    nnz: int
    nnz_min: int
    nnz_max: int
    nnz_avg: float
    nnz_var: float
    mult_min: int
    mult_max: int
    mult_avg: float
    mult_var: float
    spa_seconds: float
    # paper speedups vs SPA: (spars_16_64, spars_40_40, hspa_16_64, hspa_40_40,
    #                         hash_32_256, hash_256_256, hhash_32_256,
    #                         hhash_256_256, esc)
    paper_speedups: tuple


def _spec(name, n, nnz, zmin, zmax, zavg, zvar, mmin, mmax, mavg, mvar, spa, *sp):
    assert len(sp) == 9
    return MatrixSpec(
        name, n, nnz, zmin, zmax, zavg, zvar, mmin, mmax, mavg, mvar, spa, tuple(sp)
    )


# Table 1, transcribed. Columns: name, Size, #NNZ, nnz/col (min,max,avg,var),
# mult/col (min,max,avg,var), SPA seconds, 9 speedup columns.
SUITESPARSE_TABLE1: tuple = (
    _spec("poli", 4008, 8188, 1, 15, 2.04, 0.46, 1, 38, 3.92, 5.83, 1.50e-1,
          2.10, 2.22, 2.10, 2.21, 4.21, 3.83, 4.20, 3.83, 0.95),
    _spec("S40PI_n1", 2028, 5007, 0, 8, 2.47, 0.30, 0, 25, 6.39, 1.50, 8.69e-2,
          2.05, 2.05, 2.05, 2.04, 3.63, 3.30, 3.61, 3.28, 0.70),
    _spec("Kohonen", 4470, 12731, 0, 51, 2.85, 10.20, 0, 221, 11.88, 238.58, 2.32e-1,
          1.17, 1.21, 1.19, 1.26, 1.22, 1.27, 1.37, 1.69, 0.54),
    _spec("Hamrle2", 5952, 22162, 2, 8, 3.72, 3.42, 4, 40, 14.07, 82.28, 3.78e-1,
          1.29, 1.42, 1.29, 1.42, 2.26, 2.31, 2.25, 2.32, 0.59),
    _spec("bp_0", 822, 3276, 1, 20, 3.99, 10.43, 1, 107, 14.18, 272.39, 4.97e-2,
          1.33, 1.46, 1.41, 1.49, 1.26, 1.05, 1.43, 1.43, 0.54),
    _spec("barth4", 6019, 23492, 2, 10, 3.90, 0.68, 4, 51, 14.91, 22.04, 3.79e-1,
          1.36, 1.48, 1.36, 1.48, 2.27, 2.29, 2.28, 2.33, 0.57),
    _spec("oscil_dcop_30", 430, 1544, 1, 13, 3.59, 2.33, 1, 60, 15.00, 65.90, 2.43e-2,
          1.33, 1.45, 1.35, 1.51, 1.23, 1.13, 1.32, 1.42, 0.50),
    _spec("rw5151", 5151, 20199, 1, 4, 3.92, 0.11, 2, 16, 15.49, 3.148, 3.09e-1,
          1.32, 1.40, 1.32, 1.40, 2.20, 2.21, 2.19, 2.21, 0.53),
    _spec("olm1000", 1000, 3996, 3, 4, 4.00, 0.00, 10, 16, 15.97, 0.15, 5.39e-2,
          1.55, 1.48, 1.55, 1.48, 2.15, 2.18, 2.12, 2.16, 0.51),
    _spec("tub1000", 1000, 3996, 3, 4, 4.00, 0.00, 10, 16, 15.97, 0.15, 5.80e-2,
          1.68, 1.60, 1.68, 1.60, 2.29, 2.33, 2.28, 2.32, 0.56),
    _spec("bcspwr09", 1723, 6511, 2, 15, 3.78, 3.02, 5, 80, 17.30, 102.80, 1.10e-1,
          1.30, 1.38, 1.30, 1.37, 1.39, 1.57, 1.42, 1.77, 0.48),
    _spec("saylr3", 1000, 3750, 1, 7, 3.75, 4.06, 1, 42, 18.13, 166.59, 6.00e-2,
          1.25, 1.38, 1.26, 1.36, 1.66, 2.03, 1.63, 1.92, 0.53),
    _spec("sherman4", 1104, 3786, 1, 7, 3.43, 6.40, 1, 47, 18.16, 332.27, 5.77e-2,
          1.17, 1.23, 1.17, 1.20, 1.33, 1.53, 1.30, 1.42, 0.35),
    _spec("gh1484", 1484, 6110, 2, 13, 4.12, 2.56, 5, 68, 19.51, 94.54, 9.71e-2,
          1.28, 1.34, 1.28, 1.33, 1.38, 1.49, 1.40, 1.67, 0.43),
    _spec("shyy41", 4720, 20042, 1, 6, 4.25, 1.63, 2, 36, 19.62, 129.92, 3.12e-1,
          1.26, 1.38, 1.26, 1.38, 2.16, 2.23, 2.16, 2.23, 0.48),
    _spec("rajat03", 7602, 32653, 1, 52, 4.29, 1.26, 3, 303, 19.71, 51.70, 5.15e-1,
          1.19, 1.27, 1.22, 1.33, 1.98, 1.40, 2.16, 2.18, 0.48),
    _spec("young3c", 841, 4089, 3, 5, 4.74, 0.21, 11, 25, 22.51, 11.03, 5.85e-2,
          1.40, 1.38, 1.40, 1.38, 1.99, 2.12, 2.00, 2.12, 0.49),
    _spec("sherman3", 5005, 20033, 1, 7, 4.00, 7.09, 1, 49, 23.11, 411.19, 3.36e-1,
          1.00, 1.10, 1.09, 1.12, 1.64, 1.83, 1.34, 1.40, 0.42),
    _spec("dw1024", 2048, 10114, 3, 8, 4.94, 0.26, 11, 49, 24.54, 17.05, 1.52e-1,
          1.26, 1.23, 1.25, 1.22, 1.79, 1.84, 1.82, 1.84, 0.41),
    _spec("rdb1250", 1250, 7300, 4, 6, 5.84, 0.15, 18, 36, 34.25, 14.17, 1.07e-1,
          1.21, 1.17, 1.21, 1.17, 1.64, 1.63, 1.63, 1.63, 0.33),
    _spec("tols1090", 663, 1712, 1, 22, 3.25, 25.97, 1, 471, 38.00, 13361.58, 7.30e-2,
          0.92, 0.79, 1.36, 1.36, 0.70, 0.35, 1.52, 1.52, 0.25),
    _spec("fpga_dcop_05", 1220, 5852, 1, 36, 4.80, 20.44, 7, 164, 38.12, 427.76,
          1.09e-1, 0.95, 1.00, 1.03, 1.06, 0.90, 0.84, 1.05, 1.15, 0.32),
    _spec("watt_1", 1856, 11360, 2, 7, 6.12, 1.67, 6, 49, 39.37, 125.89, 1.72e-1,
          1.08, 1.08, 1.05, 1.05, 1.36, 1.39, 1.14, 1.13, 0.35),
    _spec("saylr4", 3564, 22316, 3, 7, 6.26, 0.56, 13, 49, 39.76, 52.96, 3.55e-1,
          0.93, 1.02, 0.98, 1.02, 1.48, 1.61, 1.16, 1.20, 0.37),
    _spec("orsreg_1", 2205, 14133, 4, 7, 6.41, 0.41, 19, 49, 41.49, 49.78, 2.06e-1,
          1.04, 1.04, 1.00, 1.00, 1.55, 1.59, 1.19, 1.20, 0.33),
    _spec("wang1", 2903, 19093, 4, 7, 6.58, 0.37, 19, 49, 43.62, 46.98, 2.93e-1,
          1.01, 1.07, 1.01, 1.03, 1.52, 1.56, 1.11, 1.12, 0.35),
    _spec("gemat12", 4929, 33044, 1, 28, 6.70, 11.56, 1, 206, 45.27, 735.35, 6.12e-1,
          0.85, 0.93, 0.99, 1.02, 0.79, 0.95, 1.06, 1.10, 0.37),
    _spec("lshp3466", 3466, 23896, 4, 7, 6.89, 0.20, 21, 49, 47.74, 20.56, 3.44e-1,
          0.94, 1.01, 0.98, 0.98, 1.46, 1.48, 1.00, 1.00, 0.31),
    _spec("LeGresley_4908", 4908, 30482, 2, 34, 6.21, 9.39, 8, 324, 48.25, 1065.07,
          5.03e-1, 0.79, 0.86, 0.99, 1.02, 1.04, 1.00, 1.17, 1.20, 0.32),
    _spec("lns_3937", 3937, 25407, 1, 13, 6.45, 10.39, 1, 113, 48.44, 866.46, 4.00e-1,
          0.82, 0.89, 0.99, 1.01, 1.22, 1.23, 1.06, 1.07, 0.32),
    _spec("pores_2", 1224, 9613, 2, 30, 7.85, 29.53, 10, 298, 63.62, 2199.05, 1.50e-1,
          0.78, 0.89, 1.01, 1.01, 0.77, 0.59, 1.03, 1.01, 0.29),
    _spec("Chebyshev3", 6435, 51480, 3, 9, 8.99, 0.02, 15, 65, 64.92, 2.12, 5.23e-1,
          0.94, 1.01, 1.01, 1.01, 1.36, 1.36, 1.00, 1.00, 0.31),
    _spec("str_200", 363, 3068, 1, 26, 8.45, 84.35, 1, 449, 70.61, 12314.86, 4.93e-2,
          0.83, 0.91, 1.02, 1.05, 0.65, 0.25, 0.99, 0.93, 0.32),
    _spec("dwt_2680", 2680, 25026, 4, 19, 9.34, 3.44, 27, 228, 90.65, 623.75, 4.01e-1,
          0.70, 0.76, 1.00, 1.01, 0.77, 0.91, 1.00, 0.99, 0.26),
    _spec("cage9", 3534, 41594, 3, 23, 11.77, 14.08, 15, 474, 152.60, 7046.60, 8.00e-1,
          0.65, 0.73, 1.00, 1.00, 0.57, 0.59, 1.00, 1.00, 0.25),
    _spec("nasa1824", 1824, 39208, 6, 42, 21.50, 49.58, 65, 1197, 511.64, 59420.46,
          8.14e-1, 0.41, 0.47, 1.00, 0.99, 0.36, 0.31, 0.99, 0.99, 0.16),
    _spec("ex22", 839, 22460, 7, 62, 26.77, 190.67, 176, 2270, 907.22, 220428.89,
          5.50e-1, 0.33, 0.41, 1.00, 1.01, 0.29, 0.20, 1.02, 1.00, 0.17),
    _spec("adder_dcop_01", 1813, 11156, 1, 1332, 6.15, 1076.11, 2, 9439, 1014.45,
          396265.13, 2.25, 0.61, 0.64, 1.00, 1.00, 0.34, 0.18, 1.00, 1.00, 0.20),
    _spec("Goodwin_013", 1965, 56059, 5, 62, 28.53, 224.66, 138, 2359, 1048.69,
          316412.44, 1.47, 0.31, 0.38, 1.00, 1.00, 0.27, 0.24, 1.00, 0.99, 0.14),
    _spec("iprob", 3001, 9000, 2, 3000, 3.00, 2994.00, 3002, 6000, 3003.00, 2994.00,
          10.33, 0.77, 0.72, 1.00, 1.00, 0.34, 0.31, 1.00, 0.99, 0.18),
)

# paper's Table-1 average-speedup row, same column order as paper_speedups
TABLE1_AVERAGE_SPEEDUPS = (1.079, 1.131, 1.204, 1.235, 1.436, 1.413, 1.535, 1.569,
                           0.399)

ALGO_COLUMNS = (
    "spars_16_64", "spars_40_40", "hspa_16_64", "hspa_40_40",
    "hash_32_256", "hash_256_256", "hhash_32_256", "hhash_256_256", "esc",
)


def name_seed(name: str) -> int:
    """A per-matrix seed salt that is the same in every process.

    (Python's ``hash`` of a string is salted per process, so a seed derived
    from it would give a different matrix in every run.)
    """
    return zlib.crc32(name.encode()) % (2**31)


def by_name(name: str) -> MatrixSpec:
    for s in SUITESPARSE_TABLE1:
        if s.name == name:
            return s
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Degree-sequence synthesis
# ---------------------------------------------------------------------------


def _degree_sequence(spec: MatrixSpec, rng: np.random.Generator) -> np.ndarray:
    """Integer degrees: exact sum/min/max, variance matched by pair transfers."""
    n, total = spec.n, spec.nnz
    lo, hi = spec.nnz_min, spec.nnz_max
    base = total // n
    deg = np.full(n, base, np.int64)
    deg[: total - base * n] += 1  # exact sum
    deg = np.clip(deg, max(lo, 0), hi)
    # repair sum after clipping (clip can only matter for degenerate specs)
    _fix_sum(deg, total, lo, hi)
    # plant the published extremes
    if deg.max() < hi:
        i = int(np.argmax(deg))
        delta = hi - deg[i]
        deg[i] = hi
        _shed(deg, delta, lo, exclude=i)
    if deg.min() > lo:
        i = int(np.argmin(deg))
        delta = deg[i] - lo
        deg[i] = lo
        _absorb(deg, delta, hi, exclude=i)
    # variance repair: batched unit transfers between *disjoint* donor/receiver
    # pairs (donors from the low end of the degree ordering, receivers from the
    # high end, paired until their sort positions cross).
    target_ss = spec.nnz_var * n + (total / n) ** 2 * n  # sum of squares target
    for _ in range(200_000):
        cur_ss = float((deg.astype(np.float64) ** 2).sum())
        err = target_ss - cur_ss
        if abs(err) <= max(2.0 * hi, 0.002 * target_ss):
            break
        asc = np.argsort(deg, kind="stable")
        pos = np.empty(n, np.int64)
        pos[asc] = np.arange(n)
        if err > 0:  # need more spread: take from small, give to large
            d_cand = asc[deg[asc] > lo]          # ascending degree
            r_cand = asc[deg[asc] < hi][::-1]    # descending degree
            k = min(len(d_cand), len(r_cand), 512)
            if k == 0:
                break
            d, r = d_cand[:k], r_cand[:k]
            keep = pos[d] < pos[r]               # disjoint by position
            d, r = d[keep], r[keep]
            if len(d) == 0:
                break
            gain = 2.0 * (deg[r] - deg[d]).astype(np.float64) + 2.0
            take = np.cumsum(gain) <= err + gain  # don't wildly overshoot
            d, r = d[take], r[take]
            if len(d) == 0:
                break
            np.add.at(deg, r, 1)
            np.add.at(deg, d, -1)
        else:  # reduce spread: take from large, give to small
            d_cand = asc[deg[asc] > lo][::-1]    # descending degree
            r_cand = asc[deg[asc] < hi]          # ascending degree
            k = min(len(d_cand), len(r_cand), 512)
            if k == 0:
                break
            d, r = d_cand[:k], r_cand[:k]
            keep = (pos[d] > pos[r]) & (deg[d] - deg[r] >= 2)
            d, r = d[keep], r[keep]
            if len(d) == 0:
                break
            loss = 2.0 * (deg[d] - deg[r]).astype(np.float64) - 2.0
            take = np.cumsum(loss) <= -err + loss
            d, r = d[take], r[take]
            if len(d) == 0:
                break
            np.add.at(deg, d, -1)
            np.add.at(deg, r, 1)
    assert deg.sum() == total, (deg.sum(), total)
    rng.shuffle(deg)
    return deg


def _fix_sum(deg, total, lo, hi):
    diff = int(total - deg.sum())
    while diff != 0:
        if diff > 0:
            idx = np.nonzero(deg < hi)[0][: abs(diff)]
            if len(idx) == 0:
                raise ValueError("cannot reach target nnz within [min,max]")
            deg[idx] += 1
            diff -= len(idx)
        else:
            idx = np.nonzero(deg > lo)[0][: abs(diff)]
            if len(idx) == 0:
                raise ValueError("cannot reach target nnz within [min,max]")
            deg[idx] -= 1
            diff += len(idx)


def _shed(deg, delta, lo, exclude):
    """Remove ``delta`` units from columns other than ``exclude``."""
    while delta > 0:
        idx = np.nonzero(deg > lo)[0]
        idx = idx[idx != exclude][:delta]
        if len(idx) == 0:
            raise ValueError("cannot shed degree mass")
        deg[idx] -= 1
        delta -= len(idx)


def _absorb(deg, delta, hi, exclude):
    while delta > 0:
        idx = np.nonzero(deg < hi)[0]
        idx = idx[idx != exclude][:delta]
        if len(idx) == 0:
            raise ValueError("cannot absorb degree mass")
        deg[idx] += 1
        delta -= len(idx)


def _sample_rows(
    deg: np.ndarray,
    beta: float,
    sigma: float,
    rng: np.random.Generator,
    chunk: int = 512,
) -> list[np.ndarray]:
    """Weighted sampling-without-replacement of row indices per column.

    Gumbel top-k per column: scores = beta_j * log(deg) + Gumbel; take the z_j
    largest. ``beta_j = beta + sigma * N(0,1)`` varies the assortativity tilt
    per column (raises the variance of multiplications-per-column).
    """
    n = len(deg)
    logd = np.log(np.maximum(deg.astype(np.float64), 0.5))
    out: list[np.ndarray] = [np.zeros(0, np.int32)] * n
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        betas = beta + sigma * rng.standard_normal(hi - lo)
        scores = betas[:, None] * logd[None, :]
        scores += rng.gumbel(size=(hi - lo, n))
        for jj in range(hi - lo):
            z = int(deg[lo + jj])
            if z == 0:
                continue
            idx = np.argpartition(scores[jj], n - z)[n - z:]
            idx.sort()
            out[lo + jj] = idx.astype(np.int32)
    return out


def _mult_moments(deg: np.ndarray, rows: list[np.ndarray]) -> tuple[float, float]:
    d = deg.astype(np.float64)
    ops = np.array([d[r].sum() for r in rows])
    return float(ops.mean()), float(ops.var())


def synthesize_suitesparse(
    spec: MatrixSpec | str, *, seed: int = 0, dtype=np.float64,
    calibrate_iters: int = 4,
) -> tuple[CSC, MatrixStats]:
    """Generate a matrix matching ``spec``'s published statistics.

    Degree sequence matches nnz/col stats exactly (sum/min/max) or near-exactly
    (variance). Row placement is calibrated: an assortativity exponent ``beta``
    is secant-fitted to the published mult/col mean, then a per-column tilt
    ``sigma`` to the published mult/col variance. Returns (matrix, stats).
    """
    if isinstance(spec, str):
        spec = by_name(spec)
    rng = np.random.default_rng(seed ^ name_seed(spec.name))
    deg = _degree_sequence(spec, rng)
    n = spec.n

    # --- calibrate beta (mult mean) by secant on the *achieved* mean --------
    def achieved(beta, sigma, salt):
        r = _sample_rows(deg, beta, sigma, np.random.default_rng(seed * 7919 + salt))
        return r, *_mult_moments(deg, r)

    b0, b1 = 0.0, 1.5
    rows, m0, _ = achieved(b0, 0.0, 0)
    _, m1, _ = achieved(b1, 0.0, 1)
    beta = b0
    best = (abs(m0 - spec.mult_avg), b0, rows)
    for it in range(calibrate_iters):
        if abs(m1 - m0) < 1e-9:
            break
        beta = b1 + (spec.mult_avg - m1) * (b1 - b0) / (m1 - m0)
        beta = float(np.clip(beta, -6.0, 10.0))
        rows, m2, _ = achieved(beta, 0.0, 2 + it)
        if abs(m2 - spec.mult_avg) < best[0]:
            best = (abs(m2 - spec.mult_avg), beta, rows)
        b0, m0, b1, m1 = b1, m1, beta, m2
        if abs(m2 - spec.mult_avg) / max(spec.mult_avg, 1.0) < 0.02:
            break
    _, beta, rows = best

    # --- calibrate sigma (mult variance) ------------------------------------
    _, mm, vv = achieved(beta, 0.0, 100)
    best_rows, best_err = rows, abs(vv - spec.mult_var)
    if vv < spec.mult_var * 0.8:  # need more spread than the base tilt gives
        for it, sigma in enumerate((0.25, 0.5, 1.0, 2.0)[: max(calibrate_iters, 1)]):
            r2, m2, v2 = achieved(beta, sigma, 200 + it)
            # keep mean fidelity: only accept if mean stays within 10 %
            if abs(m2 - spec.mult_avg) / max(spec.mult_avg, 1.0) < 0.10:
                err = abs(v2 - spec.mult_var)
                if err < best_err:
                    best_rows, best_err = r2, err
    rows = best_rows

    # Arrow-structure repair: if the published mult/col minimum can only be met
    # when every column references the heaviest column (e.g. iprob, whose one
    # 3000-nnz column appears in every other column's row set), force-include it.
    if spec.mult_min >= spec.nnz_max and spec.nnz_max > 4 * spec.nnz_avg:
        mega = int(np.argmax(deg))
        for j in range(n):
            r = rows[j]
            if len(r) and mega not in set(r.tolist()):
                # replace the lightest entry with the mega row
                repl = int(np.argmin(deg[r]))
                r = r.copy()
                r[repl] = mega
                r.sort()
                rows[j] = r

    vals_l, col_ptr = [], np.zeros(n + 1, np.int32)
    for j in range(n):
        z = len(rows[j])
        col_ptr[j + 1] = col_ptr[j] + z
        vals_l.append(rng.uniform(0.5, 1.5, size=z).astype(dtype))
    m = csc_from_numpy(np.concatenate(vals_l), np.concatenate(rows), col_ptr,
                       (n, n))
    return m, matrix_stats(m)


def load_or_synthesize(
    spec: MatrixSpec | str, *, seed: int = 0,
    cache_dir: str | None = ".cache/matrices",
) -> tuple[CSC, MatrixStats]:
    """:func:`synthesize_suitesparse` behind a cache on the local disk (the
    calibrated generation takes seconds): ``<cache_dir>/<name>_s<seed>.npz``
    holds the matrix, written atomically; an entry that does not load is
    generated and written again.  ``cache_dir=None`` skips the cache."""
    import os

    if isinstance(spec, str):
        spec = by_name(spec)
    if cache_dir is None:
        return synthesize_suitesparse(spec, seed=seed)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{spec.name}_s{seed}.npz")
    if os.path.exists(path):
        try:
            z = np.load(path)
            m = csc_from_numpy(z["values"], z["row_indices"], z["col_ptr"],
                               (int(z["n_rows"]), int(z["n_cols"])))
            return m, matrix_stats(m)
        except Exception:
            pass  # a corrupt entry: generate it again
    m, st = synthesize_suitesparse(spec, seed=seed)
    tmp = path + ".tmp.npz"
    np.savez(tmp, values=_np(m.values), row_indices=_np(m.row_indices),
             col_ptr=_np(m.col_ptr), n_rows=m.shape[0], n_cols=m.shape[1])
    os.replace(tmp, path)
    return m, st
