"""Machine profiles: the cost model's constants measured on this machine.

The constants of :mod:`repro_torch.core.cost` ship as the JAX package's
defaults, which were measured on a CPU container: on another machine
``method="auto"`` ranks engines on a model of a different machine.  This
module closes the loop: **measure, fit, persist, predict, cross-check**
(the port's copy of the JAX package's ``repro/core/profile.py``).

* :func:`machine_fingerprint` identifies the execution environment: the CPU
  model, the torch and CUDA versions, the device platform (``"cuda"`` with a
  card, else ``"cpu"``), the card's name and the device count.  A profile
  is trusted only on the fingerprint it was measured on.  The fields differ
  from the JAX package's (no ``jax`` field), so a profile that package
  wrote into the same directory is never taken for this one.
* :func:`calibrate_profile` runs a small synthetic ladder per (backend,
  engine) family (host SPA, the host product stream, the guard-tripped
  transient rebuild, the torch stream and K1 on the card, the last two on
  the stream ladder's rungs, and the mesh's cross-shard reduction over the
  visible cards) and fits each
  family's :class:`~repro_torch.core.cost.CostConstants` terms by weighted
  least squares.  It also tunes the stream guard
  (``fast.STREAM_MAX_PRODUCTS``) and the auto tile-grid nnz targets
  (``sparse.partition``).
* :func:`save_profile` / :func:`load_profile` persist the fit as one JSON
  file per fingerprint under ``REPRO_PROFILE_DIR`` (default
  ``~/.cache/repro-spgemm/profiles``); :func:`current_profile` loads it at
  the first cost-model consult, so ``DEFAULT_CONSTANTS`` is the fallback.
  With ``REPRO_AUTO_CALIBRATE=1`` a missing profile is measured at first
  use; a calibration that fails raises (it does not carry on on the
  defaults, which would hide a card failure).

Provenance (``measured`` or ``default``, fingerprint, age) is stamped into
``plan_cache_info()['profile']`` and, as :attr:`MachineProfile.tag`, into
the params and LRU keys of every tiled plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import platform
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost import CostConstants, DEFAULT_CONSTANTS

PROFILE_VERSION = 1

#: structural-knob tuning keys a profile may carry: ``stream_max_products``
#: -> ``fast.STREAM_MAX_PRODUCTS`` (the plan-memory guard),
#: ``tile_n_target``/``tile_k_target`` -> the auto tile-grid nnz targets
#: ``sparse.partition.auto_tile_grid`` sizes from.  (The JAX package also
#: tunes its Pallas kernel's product-axis block; K1 has no such block.)
TUNING_KEYS = ("stream_max_products", "tile_n_target", "tile_k_target")

_LOCK = threading.RLock()
_STATE: dict = {"profile": None, "loading": False}
_COUNTERS = {"default_auto_uses": 0, "stale_discards": 0, "load_errors": 0,
             "auto_calibrations": 0}
_WARNED: set = set()


# ---------------------------------------------------------------------------
# machine fingerprint
# ---------------------------------------------------------------------------


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def machine_fingerprint() -> dict:
    """Identity of the execution environment a profile is valid on.

    Everything the measured constants depend on: the host CPU, the torch
    and CUDA versions (kernels and libraries move with them), the device
    platform, the card's name and the device count.  Nothing per process
    (pid, time, cwd).  Needs no card: without one the platform is
    ``"cpu"``.
    """
    cuda = torch.cuda.is_available()
    return {
        "cpu": _cpu_model(),
        "machine": platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "profile_version": PROFILE_VERSION,
    }


def fingerprint_key(fp: dict | None = None) -> str:
    """Short stable hash of a fingerprint (profile filename stem)."""
    fp = machine_fingerprint() if fp is None else fp
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def profile_dir() -> str:
    """Where profiles persist: ``$REPRO_PROFILE_DIR`` or the user cache."""
    d = os.environ.get("REPRO_PROFILE_DIR")
    if d:
        return d
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-spgemm",
                        "profiles")


# ---------------------------------------------------------------------------
# the profile object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """One machine's measured cost model and tuned structural knobs.

    ``fitted`` names the :class:`CostConstants` fields that came out of this
    machine's ladder; every other field is the ``DEFAULT_CONSTANTS``
    fallback riding along (the cuda backend's relative ``p_*`` terms, which
    no ladder fits).  ``source`` is ``"measured"`` or ``"default"``.
    """

    constants: CostConstants
    fingerprint: dict
    source: str = "default"
    created_at: float = 0.0
    fitted: tuple = ()
    tuning: dict = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    @property
    def key(self) -> str:
        return fingerprint_key(self.fingerprint)

    @property
    def tag(self) -> str:
        """Provenance token recorded in plan params and LRU keys: two plans
        built under different calibrations never alias."""
        if self.source == "default":
            return "default"
        return f"{self.source}:{self.key}:{int(self.created_at)}"

    def age_seconds(self) -> Optional[float]:
        if not self.created_at:
            return None
        return max(time.time() - self.created_at, 0.0)

    def provenance(self) -> dict:
        """The stamp ``plan_cache_info()['profile']`` carries."""
        age = self.age_seconds()
        return {
            "source": self.source,
            "fingerprint_key": self.key,
            "fingerprint": dict(self.fingerprint),
            "created_at": self.created_at,
            "age_seconds": None if age is None else round(age, 3),
            "fitted": list(self.fitted),
            "tuning": dict(self.tuning),
            "path": self.path,
        }

    def to_json(self) -> dict:
        return {
            "version": PROFILE_VERSION,
            "fingerprint": dict(self.fingerprint),
            "source": self.source,
            "created_at": self.created_at,
            "fitted": list(self.fitted),
            "tuning": dict(self.tuning),
            "constants": dataclasses.asdict(self.constants),
        }

    @staticmethod
    def from_json(doc: dict, path: str | None = None) -> "MachineProfile":
        known = {f.name for f in dataclasses.fields(CostConstants)}
        vals = {k: float(v) for k, v in doc.get("constants", {}).items()
                if k in known}
        return MachineProfile(
            constants=dataclasses.replace(DEFAULT_CONSTANTS, **vals),
            fingerprint=dict(doc["fingerprint"]),
            source=str(doc.get("source", "measured")),
            created_at=float(doc.get("created_at", 0.0)),
            fitted=tuple(doc.get("fitted", ())),
            tuning={k: v for k, v in doc.get("tuning", {}).items()
                    if k in TUNING_KEYS},
            path=path,
        )


def default_profile() -> MachineProfile:
    """The fallback: ``DEFAULT_CONSTANTS``, no tuning, ``source="default"``."""
    return MachineProfile(constants=DEFAULT_CONSTANTS,
                          fingerprint=machine_fingerprint(),
                          source="default")


def save_profile(prof: MachineProfile, directory: str | None = None) -> str:
    """Persist ``prof`` as ``<fingerprint-key>.json`` under ``directory``
    (default :func:`profile_dir`); returns the written path."""
    d = profile_dir() if directory is None else directory
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{prof.key}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(prof.to_json(), f, indent=2, sort_keys=True)
    os.replace(tmp, path)   # atomic: a concurrent loader never sees a torn file
    return path


def load_profile(directory: str | None = None,
                 path: str | None = None) -> Optional[MachineProfile]:
    """Load the persisted profile for *this* machine, or ``None``.

    Looks for ``<fingerprint-key>.json`` under ``directory`` (default
    :func:`profile_dir`; ``$REPRO_PROFILE_FILE`` names a file instead), or
    reads the explicit ``path``.  A file whose stored fingerprint is not
    this machine's is discarded and counted (``stale_discards``); a file
    that does not read or parse is counted (``load_errors``); both return
    ``None``.
    """
    fp = machine_fingerprint()
    if path is None:
        d = profile_dir() if directory is None else directory
        path = os.path.join(d, f"{fingerprint_key(fp)}.json")
        env_file = os.environ.get("REPRO_PROFILE_FILE")
        if env_file:
            path = env_file
        elif not os.path.exists(path):
            return None
    try:
        with open(path) as f:
            doc = json.load(f)
        prof = MachineProfile.from_json(doc, path=path)
    except (OSError, ValueError, KeyError, TypeError):
        with _LOCK:
            _COUNTERS["load_errors"] += 1
        return None
    if prof.fingerprint != fp:
        with _LOCK:
            _COUNTERS["stale_discards"] += 1
        _warn_once(
            f"stale:{path}",
            f"persisted cost profile {path} was measured on a different "
            f"machine fingerprint (device {prof.fingerprint.get('device_kind')}"
            f" x {prof.fingerprint.get('device_count')} vs "
            f"{fp['device_kind']} x {fp['device_count']}); discarding it and "
            "falling back to DEFAULT_CONSTANTS: re-run "
            "benchmarks/torch_calibrate_profile.py")
        return None
    return prof


# ---------------------------------------------------------------------------
# current-profile state (loaded once; the cost model's constant source)
# ---------------------------------------------------------------------------


def current_profile() -> MachineProfile:
    """The profile the cost model consults when no constants are passed:
    the persisted fit for this machine's fingerprint if there is one
    (loaded once), else :func:`default_profile`.  With
    ``REPRO_AUTO_CALIBRATE=1`` a missing profile is measured on the card at
    first use and persisted; if that calibration fails, this raises."""
    p = _STATE["profile"]
    if p is not None:
        return p
    with _LOCK:
        if _STATE["profile"] is not None:
            return _STATE["profile"]
        if _STATE["loading"]:
            # a consult from inside the auto-calibration ladder
            return default_profile()
        _STATE["loading"] = True
        try:
            prof = load_profile()
            if prof is None and os.environ.get(
                    "REPRO_AUTO_CALIBRATE", "0") not in ("", "0"):
                prof = calibrate_profile(scale=0.25, reps=2, save=True)
                _COUNTERS["auto_calibrations"] += 1
            _STATE["profile"] = prof or default_profile()
        finally:
            _STATE["loading"] = False
        return _STATE["profile"]


def set_profile(prof: Optional[MachineProfile]) -> None:
    """Install ``prof`` as the current profile (``None`` resets to the
    unloaded state, so the next consult reads the disk again) and clear
    the warn-once record."""
    with _LOCK:
        _STATE["profile"] = prof
        _WARNED.clear()


def reset(counters: bool = True) -> None:
    """Forget the loaded profile (and, by default, zero the counters)."""
    with _LOCK:
        _STATE["profile"] = None
        _WARNED.clear()
        if counters:
            for k in _COUNTERS:
                _COUNTERS[k] = 0


def current_constants() -> CostConstants:
    return current_profile().constants


def profile_info() -> dict:
    """Provenance and counters, surfaced as ``plan_cache_info()['profile']``."""
    prof = current_profile()
    out = prof.provenance()
    with _LOCK:
        out.update(_COUNTERS)
    return out


def _warn_once(dedup_key: str, message: str) -> None:
    with _LOCK:
        if dedup_key in _WARNED:
            return
        _WARNED.add(dedup_key)
    warnings.warn(message, RuntimeWarning, stacklevel=3)


def note_default_auto(backend: str, candidates: tuple = ()) -> None:
    """Record that ``method="auto"`` ranked device engines on
    ``DEFAULT_CONSTANTS``: counted in ``default_auto_uses`` every time,
    warned once per backend.  Only a device backend, or a candidate set
    with a device family (``"torch"``, ``"fused"``), counts: the device
    constants are the ones that move from machine to machine."""
    from repro_torch.core import backends

    device_families = {"torch", "fused"}
    contract = backends.get_backend(backend)
    if not (contract.device_resident or device_families & set(candidates)):
        return
    with _LOCK:
        _COUNTERS["default_auto_uses"] += 1
    _warn_once(
        f"default-auto:{backend}",
        f"method='auto' on backend={backend!r} is ranking device engines "
        "with uncalibrated DEFAULT_CONSTANTS (no cost profile persisted "
        f"for this machine fingerprint {fingerprint_key()}); its picks are "
        "a snapshot of another machine: run "
        "benchmarks/torch_calibrate_profile.py (or set "
        "REPRO_AUTO_CALIBRATE=1) to measure this machine")


def apply_tuning(prof: MachineProfile | None = None) -> dict:
    """Apply a profile's tuned structural knobs to the live module globals.

    Sets ``fast.STREAM_MAX_PRODUCTS`` from ``prof.tuning`` (the tile targets
    are read live by ``sparse.partition.auto_tile_grid`` and need no
    global).  Never run on load: the guard is part of every stream plan's
    LRU key, so changing it builds those plans again.  Returns
    ``{knob: value}`` for what was applied.
    """
    from repro_torch.core import fast

    prof = current_profile() if prof is None else prof
    applied = {}
    if "stream_max_products" in prof.tuning:
        fast.STREAM_MAX_PRODUCTS = int(prof.tuning["stream_max_products"])
        applied["stream_max_products"] = fast.STREAM_MAX_PRODUCTS
    return applied


# ---------------------------------------------------------------------------
# rank correlation (the predict-vs-measure cross-check)
# ---------------------------------------------------------------------------


def rank_correlation(x, y) -> float:
    """Spearman rank correlation (average ranks for ties, scipy-free).

    The cost model only has to order candidates, so a fit is judged by how
    well predicted costs *rank* against measured times.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.shape != y.shape or x.ndim != 1:
        raise ValueError(f"need equal-length 1-D arrays, got {x.shape} "
                         f"vs {y.shape}")
    if len(x) < 2:
        return 1.0

    def _ranks(v):
        order = np.argsort(v, kind="stable")
        sv = v[order]
        # average rank per tie group
        boundary = np.empty(len(sv), bool)
        boundary[0] = True
        np.not_equal(sv[1:], sv[:-1], out=boundary[1:])
        group = np.cumsum(boundary) - 1
        counts = np.bincount(group)
        firsts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        avg = firsts + (counts - 1) / 2.0
        out = np.empty(len(v))
        out[order] = avg[group]
        return out

    rx, ry = _ranks(x), _ranks(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = math.sqrt(float((rx ** 2).sum()) * float((ry ** 2).sum()))
    if denom == 0.0:
        return 1.0
    return float((rx * ry).sum() / denom)


# ---------------------------------------------------------------------------
# fitting (pure: measurement rows in, constants out)
# ---------------------------------------------------------------------------


def fit_fields(fields: tuple, rows, times, floor: float = 1e-12) -> dict:
    """Weighted least squares fit of ``times ~ rows @ coeffs``.

    ``rows[i]`` holds one feature value per field (``[1, flops]`` for a
    base + slope family).  Rows are weighted by ``1/t``, so each contributes
    its relative error; otherwise the largest config dominates and the base
    terms come out meaningless.  Coefficients are clamped to ``>= floor``:
    a cost term is a duration.
    """
    a = np.asarray(rows, float)
    t = np.asarray(times, float)
    if a.ndim != 2 or a.shape != (len(t), len(fields)):
        raise ValueError(
            f"rows {a.shape} inconsistent with {len(t)} times / "
            f"{len(fields)} fields")
    w = 1.0 / np.maximum(t, 1e-12)
    coef, *_ = np.linalg.lstsq(a * w[:, None], t * w, rcond=None)
    return {f: float(max(c, floor)) for f, c in zip(fields, coef)}


def fit_constants(sections, base: CostConstants | None = None
                  ) -> tuple[CostConstants, tuple]:
    """Fold per-family measurement sections into one ``CostConstants``.

    ``sections``: ``(fields, rows, times)`` triples, one per family.
    Returns the merged constants (unmeasured fields keep ``base``'s values)
    and the sorted tuple of fitted field names.
    """
    base = DEFAULT_CONSTANTS if base is None else base
    fitted: dict = {}
    for fields, rows, times in sections:
        fitted.update(fit_fields(tuple(fields), rows, times))
    return dataclasses.replace(base, **fitted), tuple(sorted(fitted))


# ---------------------------------------------------------------------------
# the synthetic microbenchmark ladder
# ---------------------------------------------------------------------------


def _best_of(fn, reps: int) -> float:
    """Min-of-reps wall time: the de-noised estimate a fit can trust."""
    best = math.inf
    for _ in range(max(int(reps), 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _synced(fn, dev: torch.device):
    """``fn`` followed by a wait for the card: an execute on the card only
    queues its work, and a host clock around the queueing alone would fit
    the per-product terms near the floor."""
    if dev.type != "cuda":
        return fn

    def run():
        fn()
        torch.cuda.synchronize(dev)

    return run


def _dense_sparse_pair(m: int, n: int, per_col: int, rng):
    """Dense A (every B entry fans out m products) x sparse B: the flop
    ladder's workhorse, flops = nnz_b * m exactly."""
    from repro_torch.sparse.format import csc_from_dense

    a = csc_from_dense(np.ones((m, m), np.float32))
    bd = np.zeros((m, n), np.float32)
    for j in range(n):
        bd[rng.integers(m, size=min(per_col, m)), j] = 1.0
    return a, csc_from_dense(bd)


def _measure_spa(scale: float, reps: int, rng):
    """Host SPA family: time = spa_col*n + spa_entry*nnz_b + spa_flop*flops.

    Three regimes isolate the three terms (all-empty columns, entry-heavy,
    flop-heavy) plus a mixed row to anchor the joint fit.
    """
    from repro_torch.core.naive import spa_numpy
    from repro_torch.sparse.format import csc_from_dense, csc_from_numpy

    fields = ("spa_col", "spa_entry", "spa_flop")
    rows, times = [], []

    n = max(int(3000 * scale), 200)
    a0 = csc_from_dense(np.zeros((32, 32), np.float32))
    b0 = csc_from_numpy(np.zeros(0, np.float32), np.zeros(0, np.int32),
                        np.zeros(n + 1, np.int32), (32, n))
    rows.append([n, 0.0, 0.0])
    times.append(_best_of(lambda: spa_numpy(a0, b0), reps))

    k, n = 256, max(int(1500 * scale), 150)
    ad = np.zeros((k, k), np.float32)
    ad[0, :] = 1.0
    a1 = csc_from_dense(ad)
    bd = np.zeros((k, n), np.float32)
    for j in range(n):
        bd[rng.integers(k, size=4), j] = 1.0
    b1 = csc_from_dense(bd)
    rows.append([n, b1.nnz, b1.nnz])     # 1 nnz/A-col: flops == nnz_b
    times.append(_best_of(lambda: spa_numpy(a1, b1), reps))

    m = max(int(768 * scale), 192)
    a2, b2 = _dense_sparse_pair(m, 192, 8, rng)
    rows.append([192, b2.nnz, b2.nnz * m])
    times.append(_best_of(lambda: spa_numpy(a2, b2), reps))

    m = max(int(384 * scale), 96)
    a3, b3 = _dense_sparse_pair(m, max(int(600 * scale), 100), 3, rng)
    rows.append([b3.n_cols, b3.nnz, b3.nnz * m])
    times.append(_best_of(lambda: spa_numpy(a3, b3), reps))
    return fields, rows, times


def _stream_ladder(scale: float, rng):
    """(host plan, a, b, flops) rungs spanning the stream engines' flop
    range.

    The near-empty (8, 4, 1) rung is there on purpose: it pins the base
    (dispatch or launch) terms, which a flop ladder alone under-determines.
    An unpinned base fits negative, clamps to the floor, and a free base
    makes auto pick that engine for every tiny tile.
    """
    from repro_torch.core.planner import plan_spgemm

    out = []
    for m, n, per in ((8, 4, 1), (64, 32, 2), (192, 96, 4),
                      (max(int(512 * scale), 128), 128, 6),
                      (max(int(1024 * scale), 256), 256, 8)):
        a, b = _dense_sparse_pair(m, n, per, rng)
        out.append((plan_spgemm(a, b, "expand", backend="host",
                                stream_limit=b.nnz * m + 1),
                    a, b, b.nnz * m))
    return out


def _measure_stream(ladder, reps: int):
    """Host plan-resident product stream: stream_base + stream_prod*P."""
    fields = ("stream_base", "stream_prod")
    rows, times = [], []
    for plan, a, b, flops in ladder:
        plan.execute(a, b, engine="stream")   # warm-up: the stream's build
        rows.append([1.0, flops])
        times.append(_best_of(
            lambda: plan.execute(a, b, engine="stream"), reps))
    return fields, rows, times


def _measure_expand(ladder, reps: int):
    """Guard-tripped transient rebuild: expand_base + expand_prod*P +
    expand_sort*P*log2(P) per call (nothing plan-resident)."""
    from repro_torch.core.expand import spgemm_expand

    fields = ("expand_base", "expand_prod", "expand_sort")
    rows, times = [], []
    for _, a, b, flops in ladder:
        rows.append([1.0, flops, flops * math.log2(max(flops, 2))])
        times.append(_best_of(lambda: spgemm_expand(a, b), reps))
    return fields, rows, times


def _measure_torch(ladder, reps: int, dev: torch.device):
    """The torch stream (``backend="torch"``) on ``dev``: torch_base +
    torch_prod*P, in the steady state (stream built and lifted), host
    operands, each call waited for."""
    from repro_torch.core.planner import plan_spgemm

    fields = ("torch_base", "torch_prod")
    rows, times = [], []
    for _, a, b, flops in ladder:
        plan = plan_spgemm(a, b, "expand", backend="torch",
                           stream_limit=flops + 1, device=dev)
        run = _synced(lambda: plan.execute(a, b), dev)
        run()   # the stream's build and lift
        rows.append([1.0, flops])
        times.append(_best_of(run, reps))
    return fields, rows, times


def _measure_fused(ladder, reps: int, dev: torch.device):
    """K1 (``engine="fused"`` on a torch plan, as the auto grid's
    ``"fused"`` tiles run it): fused_base + fused_prod*P, on the stream
    ladder's rungs.

    The JAX package measures its fused kernel on a ladder of its own, of at
    most ~16k products, because on a CPU that kernel runs interpreted at
    minutes per Mproduct.  K1 runs on the card in microseconds, and on so
    short a ladder its per-product term is noise around the launch: it
    fitted 6e-10 s on the H100, ranking the torch stream ahead of K1 at a
    million products, where K1 was 6-9x faster.
    """
    from repro_torch.core.planner import plan_spgemm

    fields = ("fused_base", "fused_prod")
    rows, times = [], []
    for _, a, b, flops in ladder:
        plan = plan_spgemm(a, b, "expand", backend="torch",
                           stream_limit=flops + 1, device=dev)
        run = _synced(lambda: plan.execute(a, b, engine="fused"), dev)
        run()   # the views' build and lift
        rows.append([1.0, flops])
        times.append(_best_of(run, reps))
    return fields, rows, times


def _measure_comm(scale: float, reps: int, dev: torch.device):
    """The mesh's cross-shard reduction
    (``distributed.spgemm_mesh.reduce_bins``, the step the JAX package's
    ``psum_scatter`` ladder times) over growing payloads: comm_base +
    comm_byte * bytes, where D shards' reduction of an S-slot f32 axis
    moves ``4*S*(D-1)/D`` bytes off each shard.

    The shards are the visible cards, one a shard, on ``dev``'s platform
    (the CPU alone on the host).  With one shard no byte crosses a link, so
    only ``comm_base`` is fitted and ``comm_byte`` keeps its value, not
    reported as fitted.  Several shards on one card would time an add on
    the card, not a link, so the ladder never stacks them there.
    """
    from repro_torch.distributed.spgemm_mesh import reduce_bins

    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    d = len(devices)
    fields = ("comm_base", "comm_byte") if d > 1 else ("comm_base",)
    rows, times = [], []
    for s in (int(8e3 * scale) + d, int(1e5 * scale) + d,
              int(5e5 * scale) + d, int(2e6 * scale) + d):
        s = -(-s // d) * d
        parts = [torch.ones(s, device=x) for x in devices]

        def run():
            reduce_bins(parts, devices)
            for x in devices:
                if x.type == "cuda":
                    torch.cuda.synchronize(x)

        run()
        rows.append([1.0, 4.0 * s * (d - 1) / d][: len(fields)])
        times.append(_best_of(run, reps))
    return fields, rows, times


# ---------------------------------------------------------------------------
# structural-knob tuning
# ---------------------------------------------------------------------------


def _tune_stream_guard() -> int:
    """The plan-memory guard sized from this machine's RAM instead of the
    shipped 8M: ~20 plan-resident bytes per product, budgeted at 5% of
    physical memory, clamped to [1M, 64M] products.  (The rule is the JAX
    package's, whose streams live in host memory; the port's torch and
    fused streams live in the card's.)"""
    from repro_torch.core import fast

    if not hasattr(os, "sysconf"):
        return fast.DEFAULT_STREAM_MAX_PRODUCTS
    try:
        ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return fast.DEFAULT_STREAM_MAX_PRODUCTS
    return int(min(max(ram * 0.05 / 20.0, 1_000_000), 64_000_000))


def _tune_tile_targets(constants: CostConstants, scale: float, reps: int,
                       rng, dev: torch.device) -> tuple[int, int]:
    """Measured argmin over auto tile-grid nnz targets on a small
    mixed-density probe.  Each candidate goes through the real path: a
    trial profile carrying the targets is installed, a host-backend auto
    plan is built under it (its ``"torch"``/``"fused"`` tiles on ``dev``),
    and its execute is timed."""
    from repro_torch.core.planner import plan_spgemm_tiled
    from repro_torch.sparse.format import csc_from_dense

    m, n_sparse, dense = 128, max(int(512 * scale), 128), 12
    ad = np.zeros((m, m))
    ad[:, :dense] = rng.uniform(0.5, 1.5, size=(m, dense))
    for j in range(dense, m):
        ad[rng.integers(m, size=2), j] = 1.0
    bd = np.zeros((m, dense + n_sparse))
    for j in range(dense):
        bd[rng.choice(dense, size=dense, replace=False), j] = 1.0
    for j in range(dense, dense + n_sparse):
        bd[dense + rng.integers(m - dense, size=2), j] = 1.0
    a = csc_from_dense(ad.astype(np.float32))
    b = csc_from_dense(bd.astype(np.float32))

    prev = _STATE["profile"]
    best, best_t = None, math.inf
    try:
        for n_target in (2048, 8192, 32768):
            trial = MachineProfile(
                constants=constants, fingerprint=machine_fingerprint(),
                source="measured", created_at=time.time(),
                tuning={"tile_n_target": n_target,
                        "tile_k_target": 16 * n_target})
            set_profile(trial)
            # the JAX package's default backend for tiled plans is "host";
            # the port's is "cuda", so it is named here
            plan = plan_spgemm_tiled(a, b, backend="host", cache=False,
                                     constants=constants, device=dev)
            run = _synced(lambda: plan.execute(a, b), dev)
            run()
            t = _best_of(run, reps)
            if t < best_t:
                best, best_t = n_target, t
    finally:
        set_profile(prev)
    return int(best), int(16 * best)


# ---------------------------------------------------------------------------
# the calibration entry point
# ---------------------------------------------------------------------------

SECTIONS = ("spa", "stream", "expand", "torch", "fused", "comm")


def calibrate_profile(*, scale: float = 1.0, reps: int = 3,
                      sections: tuple = SECTIONS, tune: bool = True,
                      seed: int = 0, save: bool = False,
                      directory: str | None = None,
                      base: MachineProfile | None = None,
                      device=None) -> MachineProfile:
    """Run the ladder, fit constants, optionally persist.

    ``scale`` shrinks the ladder (0.25 is the smoke ladder); ``sections``
    restricts which families are measured, and the unmeasured fields keep
    ``base``'s values (default: the persisted profile if any, else
    ``DEFAULT_CONSTANTS``).  ``tune=True`` also sizes the stream guard and
    searches the tile targets.  ``save=True`` persists the result with
    :func:`save_profile` and installs it as the current profile.
    ``device`` is where the ``torch`` and ``fused`` ladders and the
    tile-target probe's device tiles run, and whose platform's devices the
    ``comm`` ladder reduces across: ``None`` is the card, and raises
    without one.
    """
    from repro_torch.device import resolve_device

    bad = [s for s in sections if s not in SECTIONS]
    if bad:
        raise ValueError(f"unknown sections {bad}; one of {SECTIONS}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if base is None:
        base = load_profile(directory=directory) or default_profile()

    measured = []
    ladder = None
    if {"stream", "expand", "torch", "fused"} & set(sections):
        ladder = _stream_ladder(scale, rng)
    if "spa" in sections:
        measured.append(_measure_spa(scale, reps, rng))
    if "stream" in sections:
        measured.append(_measure_stream(ladder, reps))
    if "expand" in sections:
        measured.append(_measure_expand(ladder, reps))
    if "torch" in sections:
        measured.append(_measure_torch(ladder, reps, dev))
    if "fused" in sections:
        measured.append(_measure_fused(ladder, reps, dev))
    if "comm" in sections:
        measured.append(_measure_comm(scale, reps, dev))

    constants, fitted = fit_constants(measured, base=base.constants)
    fitted = tuple(sorted(set(base.fitted) | set(fitted)))

    tuning = dict(base.tuning)
    if tune:
        tuning["stream_max_products"] = _tune_stream_guard()
        if "spa" in sections or "stream" in sections:
            n_t, k_t = _tune_tile_targets(constants, scale, reps, rng, dev)
            tuning["tile_n_target"], tuning["tile_k_target"] = n_t, k_t

    prof = MachineProfile(constants=constants,
                          fingerprint=machine_fingerprint(),
                          source="measured", created_at=time.time(),
                          fitted=fitted, tuning=tuning)
    if save:
        path = save_profile(prof, directory=directory)
        prof = dataclasses.replace(prof, path=path)
        set_profile(prof)
    return prof
