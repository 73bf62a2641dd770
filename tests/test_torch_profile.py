"""The port's machine profiles (``repro_torch.core.profile``) against the JAX
package's (``repro.core.profile``).

``tests/test_profile.py`` on the port, but for its two mesh tests (they wait
for the mesh) and its benchmark-header test: the fingerprint, JSON
persistence and the discarding of another machine's file, the lazily loaded
current profile, the weighted least-squares fit, the Spearman cross-check,
profile-driven ``choose_method`` picks, the stale-constants warning, the
tuned knobs and the profile tag in tiled plans, their LRU keys and
``plan_cache_info``.  Then the pure functions equal to the reference's on the
same inputs, a profile the reference wrote into the same directory never
loaded, a failing auto-calibration raising, and one small calibration on
the CPU round-tripping through the disk.  About 10 s.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.fast as ref_fast  # noqa: E402
import repro.core.profile as ref_profile  # noqa: E402
from repro.core.cost import DEFAULT_CONSTANTS as REF_DEFAULTS  # noqa: E402

import repro_torch.core.fast as fast  # noqa: E402
from repro_torch.core import plan_cache_clear, plan_cache_info  # noqa: E402
from repro_torch.core import profile  # noqa: E402
from repro_torch.core.backends import get_backend  # noqa: E402
from repro_torch.core.cost import (  # noqa: E402
    DEFAULT_CONSTANTS,
    choose_method,
    estimate_cost,
)
from repro_torch.core.planner import plan_spgemm_tiled  # noqa: E402
from repro_torch.sparse.format import csc_from_dense  # noqa: E402
from repro_torch.sparse.partition import auto_tile_grid  # noqa: E402
from repro_torch.sparse.stats import tile_stats  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_profile(tmp_path, monkeypatch):
    """Every test starts with no loaded profile, a private profile dir and
    the stock stream guard (several tests retune it); the reference's
    profile state is reset too."""
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_PROFILE_FILE", raising=False)
    monkeypatch.delenv("REPRO_AUTO_CALIBRATE", raising=False)
    guard = fast.STREAM_MAX_PRODUCTS
    profile.reset()
    ref_profile.reset()
    yield
    profile.reset()
    ref_profile.reset()
    fast.STREAM_MAX_PRODUCTS = guard
    plan_cache_clear()


def _measured(constants=None, tuning=None, fitted=()):
    return profile.MachineProfile(
        constants=constants or DEFAULT_CONSTANTS,
        fingerprint=profile.machine_fingerprint(),
        source="measured", created_at=1.0, fitted=tuple(fitted),
        tuning=dict(tuning or {}))


def _pair(m=24, n=16, per=2, seed=0):
    rng = np.random.default_rng(seed)
    ad = rng.uniform(0.5, 1.5, size=(m, m)) * (rng.random((m, m)) < 0.3)
    bd = np.zeros((m, n))
    for j in range(n):
        bd[rng.integers(m, size=per), j] = 1.0
    return (csc_from_dense(ad.astype(np.float32)),
            csc_from_dense(bd.astype(np.float32)))


# ---------------------------------------------------------------------------
# fingerprint + persistence
# ---------------------------------------------------------------------------


def test_fingerprint_deterministic():
    fp1, fp2 = profile.machine_fingerprint(), profile.machine_fingerprint()
    assert fp1 == fp2
    assert profile.fingerprint_key(fp1) == profile.fingerprint_key(fp2)
    for field in ("cpu", "machine", "torch", "cuda", "platform",
                  "device_kind", "device_count", "profile_version"):
        assert field in fp1
    assert "jax" not in fp1
    assert fp1["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert (fp1["platform"], fp1["device_kind"]) == ("cpu", "cpu")


def test_fingerprint_key_sensitive_to_fields():
    fp = profile.machine_fingerprint()
    other = dict(fp, device_count=fp["device_count"] + 7)
    assert profile.fingerprint_key(fp) != profile.fingerprint_key(other)
    renamed = dict(fp, device_kind="another card")
    assert profile.fingerprint_key(fp) != profile.fingerprint_key(renamed)


def test_save_load_roundtrip(tmp_path):
    c = dataclasses.replace(DEFAULT_CONSTANTS, torch_base=1.25e-4,
                            fused_prod=3.5e-9)
    prof = _measured(c, tuning={"stream_max_products": 123_456,
                                "tile_n_target": 64},
                     fitted=("torch_base",))
    path = profile.save_profile(prof, directory=str(tmp_path))
    assert os.path.exists(path)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    back = profile.load_profile(directory=str(tmp_path))
    assert back is not None
    assert back.source == "measured"
    assert back.constants.torch_base == pytest.approx(1.25e-4)
    assert back.constants.fused_prod == pytest.approx(3.5e-9)
    assert back.constants.spa_col == DEFAULT_CONSTANTS.spa_col
    assert back.fitted == ("torch_base",)
    assert back.tuning == {"stream_max_products": 123_456,
                           "tile_n_target": 64}
    assert back.tag == prof.tag
    assert back.path == path


def test_unknown_tuning_and_constant_keys_are_dropped(tmp_path):
    """A file carrying the JAX package's ``fused_block`` knob (K1 has no
    such block) or its ``jax_*`` constants loads without them; its
    ``comm_*`` terms, which the port's mesh shares, load."""
    doc = _measured().to_json()
    doc["tuning"] = {"fused_block": 64, "stream_max_products": 5}
    doc["constants"]["jax_base"] = 1.0
    doc["constants"]["comm_byte"] = 1.0
    path = tmp_path / "p.json"
    path.write_text(json.dumps(doc))
    back = profile.load_profile(path=str(path))
    assert back.tuning == {"stream_max_products": 5}
    assert back.constants == dataclasses.replace(DEFAULT_CONSTANTS,
                                                 comm_byte=1.0)


def test_load_missing_returns_none(tmp_path):
    assert profile.load_profile(directory=str(tmp_path / "empty")) is None


def test_fingerprint_mismatch_invalidates(tmp_path):
    """A profile measured under another fingerprint (another card, another
    device count) is discarded, not reused."""
    prof = _measured()
    doc = prof.to_json()
    doc["fingerprint"]["device_count"] += 7
    path = tmp_path / f"{prof.key}.json"
    path.write_text(json.dumps(doc))
    before = profile.profile_info()["stale_discards"]
    with pytest.warns(RuntimeWarning, match="different machine"):
        got = profile.load_profile(path=str(path))
    assert got is None
    assert profile.profile_info()["stale_discards"] == before + 1


def test_corrupt_profile_falls_back(tmp_path):
    d = tmp_path / "profiles"
    d.mkdir()
    (d / f"{profile.fingerprint_key()}.json").write_text("{not json")
    assert profile.load_profile(directory=str(d)) is None
    assert profile.profile_info()["load_errors"] >= 1
    # a file without a fingerprint is a load error too
    (d / f"{profile.fingerprint_key()}.json").write_text("{}")
    before = profile.profile_info()["load_errors"]
    assert profile.load_profile(directory=str(d)) is None
    assert profile.profile_info()["load_errors"] == before + 1


def test_current_profile_lazy_loads_from_dir(tmp_path, monkeypatch):
    d = tmp_path / "profiles"
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(d))
    profile.save_profile(
        _measured(dataclasses.replace(DEFAULT_CONSTANTS, torch_prod=9e-7)),
        directory=str(d))
    profile.reset()
    p = profile.current_profile()
    assert p.source == "measured"
    assert p.constants.torch_prod == pytest.approx(9e-7)
    # and without a persisted file the fallback is the default profile
    profile.reset()
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "nothing"))
    assert profile.current_profile().source == "default"
    assert profile.current_constants() is DEFAULT_CONSTANTS


def test_profile_file_env_names_the_file(tmp_path, monkeypatch):
    prof = _measured(fitted=("spa_col",))
    path = profile.save_profile(prof, directory=str(tmp_path / "elsewhere"))
    monkeypatch.setenv("REPRO_PROFILE_FILE", path)
    assert profile.load_profile(directory=str(tmp_path / "empty")).tag \
        == prof.tag


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def test_fit_fields_recovers_exact_coefficients():
    rows = [[1.0, f] for f in (10, 100, 1000, 50_000)]
    times = [2e-5 + 3e-8 * f for _, f in rows]
    out = profile.fit_fields(("base", "slope"), rows, times)
    assert out["base"] == pytest.approx(2e-5, rel=1e-6)
    assert out["slope"] == pytest.approx(3e-8, rel=1e-6)


def test_fit_fields_clamps_negative_coefficients():
    # a decreasing "cost" drives the slope negative; a duration cannot be,
    # so the fit clamps at the floor instead
    rows = [[1.0, f] for f in (10, 100, 1000)]
    times = [1e-3 - 9e-7 * f for _, f in rows]
    out = profile.fit_fields(("base", "slope"), rows, times)
    assert out["slope"] == pytest.approx(1e-12)


def test_fit_fields_weights_relative_error():
    # one giant config must not drown the small ones: with 1/t weighting
    # the base term of the small rows survives a 1000x larger row
    rows = [[1.0, 1.0], [1.0, 2.0], [1.0, 1e6]]
    times = [1e-4 + 1e-7 * r[1] for r in rows]
    out = profile.fit_fields(("base", "slope"), rows, times)
    assert out["base"] == pytest.approx(1e-4, rel=1e-3)


def test_fit_fields_shape_mismatch():
    with pytest.raises(ValueError, match="inconsistent"):
        profile.fit_fields(("a",), [[1.0, 2.0]], [1.0])


def test_fit_constants_merges_sections():
    c, fitted = profile.fit_constants([
        (("torch_base", "torch_prod"),
         [[1.0, f] for f in (10, 1000, 1e5)],
         [4e-5 + 5e-8 * f for f in (10, 1000, 1e5)]),
        (("fused_base",), [[1.0]], [2e-4]),
    ])
    assert fitted == ("fused_base", "torch_base", "torch_prod")
    assert c.torch_base == pytest.approx(4e-5, rel=1e-5)
    assert c.torch_prod == pytest.approx(5e-8, rel=1e-5)
    assert c.fused_base == pytest.approx(2e-4, rel=1e-6)
    # unmeasured fields ride along from the base constants
    assert c.spa_entry == DEFAULT_CONSTANTS.spa_entry


# ---------------------------------------------------------------------------
# rank correlation
# ---------------------------------------------------------------------------


def test_rank_correlation_basics():
    assert profile.rank_correlation([1, 2, 3], [10, 20, 30]) == 1.0
    assert profile.rank_correlation([1, 2, 3], [3, 2, 1]) == -1.0
    # a monotone nonlinear map keeps the ranks
    x = np.asarray([1.0, 4.0, 2.0, 8.0, 3.0])
    assert profile.rank_correlation(x, np.exp(x)) == 1.0
    # ties get average ranks on both sides
    assert profile.rank_correlation([1, 1, 2], [5, 5, 9]) == 1.0
    assert profile.rank_correlation([1.0], [2.0]) == 1.0
    assert profile.rank_correlation([2, 2, 2], [1, 5, 9]) == 1.0


def test_rank_correlation_rejects_mismatched():
    with pytest.raises(ValueError):
        profile.rank_correlation([1, 2], [1, 2, 3])


def test_synthetic_fit_ranks_methods():
    """A profile fitted from noisy synthetic timings ranks per-(tile,
    method) costs with Spearman >= 0.8 against those timings."""
    truth = dataclasses.replace(
        DEFAULT_CONSTANTS, spa_col=5e-6, spa_entry=9e-6, spa_flop=2e-8,
        stream_base=1.2e-5, stream_prod=8e-9, torch_base=9e-5,
        torch_prod=5e-8)
    rng = np.random.default_rng(7)
    stats = [tile_stats(*_pair(m, n, per, seed))
             for seed, (m, n, per) in enumerate(
                 [(16, 8, 1), (24, 16, 2), (48, 32, 3), (64, 48, 4),
                  (96, 64, 5), (128, 96, 6)])]

    def noisy(t):
        return float(t * rng.uniform(0.9, 1.1))

    sections = [
        (("spa_col", "spa_entry", "spa_flop"),
         [[s.n, s.nnz_b, s.flops] for s in stats],
         [noisy(truth.spa_col * s.n + truth.spa_entry * s.nnz_b
                + truth.spa_flop * s.flops) for s in stats]),
        (("stream_base", "stream_prod"),
         [[1.0, s.flops] for s in stats],
         [noisy(truth.stream_base + truth.stream_prod * s.flops)
          for s in stats]),
        (("torch_base", "torch_prod"),
         [[1.0, s.flops] for s in stats],
         [noisy(truth.torch_base + truth.torch_prod * s.flops)
          for s in stats]),
    ]
    fitted, names = profile.fit_constants(sections)
    assert "spa_flop" in names and "torch_prod" in names

    measured, predicted = [], []
    for (fields, _, times), method in zip(sections,
                                          ("spa", "expand", "torch")):
        for s, t in zip(stats, times):
            measured.append(t)
            predicted.append(estimate_cost(s, method, "host",
                                           constants=fitted))
    rc = profile.rank_correlation(predicted, measured)
    assert rc >= 0.8, f"Spearman {rc:.3f} below the 0.8 gate"


# ---------------------------------------------------------------------------
# profile-driven decisions
# ---------------------------------------------------------------------------


def test_choose_method_consults_profile():
    a, b = _pair()
    st = tile_stats(a, b)
    baseline = choose_method(st, "host", constants=DEFAULT_CONSTANTS)
    assert baseline == "expand"
    # a machine where every stream engine's dispatch costs a full second
    # re-ranks the same tile to SPA, through the installed profile, with no
    # constants at the call
    slow_streams = dataclasses.replace(
        DEFAULT_CONSTANTS, stream_base=1.0, expand_base=1.0, torch_base=1.0,
        fused_base=1.0)
    profile.set_profile(_measured(slow_streams))
    assert choose_method(st, "host") == "spa"
    # and one where K1 is nearly free ranks "fused" first
    free_k1 = dataclasses.replace(DEFAULT_CONSTANTS, fused_base=1e-12,
                                  fused_prod=1e-15)
    profile.set_profile(_measured(free_k1))
    assert choose_method(st, "host") == "fused"
    assert choose_method(st, "torch") == "fused"
    profile.set_profile(None)


def test_default_auto_warns_once_and_counts():
    a, b = _pair()
    st = tile_stats(a, b)
    before = plan_cache_info()["profile"]["default_auto_uses"]
    with pytest.warns(RuntimeWarning, match="uncalibrated"):
        choose_method(st, "host")
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the second consult stays silent
        choose_method(st, "host")
    info = plan_cache_info()["profile"]
    assert info["default_auto_uses"] == before + 2
    assert info["source"] == "default"


def test_device_backends_count_without_device_candidates():
    """The cuda and torch backends run on the card: their rankings count
    whatever the candidates."""
    a, b = _pair()
    st = tile_stats(a, b)
    with pytest.warns(RuntimeWarning, match="backend='cuda'"):
        choose_method(st, "cuda", candidates=("spa", "hash-256/256"))
    assert plan_cache_info()["profile"]["default_auto_uses"] == 1


def test_host_only_candidates_do_not_warn():
    a, b = _pair()
    st = tile_stats(a, b)
    before = plan_cache_info()["profile"]["default_auto_uses"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        choose_method(st, "host", candidates=("spa", "expand"))
    assert plan_cache_info()["profile"]["default_auto_uses"] == before


def test_measured_profile_does_not_warn():
    a, b = _pair()
    st = tile_stats(a, b)
    profile.set_profile(_measured())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        choose_method(st, "host")
    assert plan_cache_info()["profile"]["default_auto_uses"] == 0


# ---------------------------------------------------------------------------
# structural-knob tuning
# ---------------------------------------------------------------------------


def test_apply_tuning_sets_knobs():
    prof = _measured(tuning={"stream_max_products": 123_456})
    applied = profile.apply_tuning(prof)
    assert applied == {"stream_max_products": 123_456}
    assert fast.STREAM_MAX_PRODUCTS == 123_456


def test_apply_tuning_untouched_without_keys():
    before = fast.STREAM_MAX_PRODUCTS
    assert profile.apply_tuning(_measured()) == {}
    assert fast.STREAM_MAX_PRODUCTS == before


def test_apply_tuning_defaults_to_the_current_profile():
    profile.set_profile(_measured(tuning={"stream_max_products": 77}))
    assert profile.apply_tuning() == {"stream_max_products": 77}
    assert fast.STREAM_MAX_PRODUCTS == 77


def test_auto_tile_grid_consults_tuning():
    a, b = _pair(m=32, n=24, per=4)
    default_grid = auto_tile_grid(a, b)
    assert default_grid == (1, 1)   # far under the shipped targets
    profile.set_profile(_measured(tuning={"tile_n_target": 8,
                                          "tile_k_target": 16}))
    tuned_grid = auto_tile_grid(a, b)
    assert tuned_grid[1] > 1
    assert tuned_grid[0] > 1
    # explicit targets always win over the profile
    assert auto_tile_grid(a, b, n_target=10 ** 9, k_target=10 ** 9) == (1, 1)


# ---------------------------------------------------------------------------
# provenance in plans / cache keys / info
# ---------------------------------------------------------------------------


def test_tiled_plan_params_carry_profile_tag():
    a, b = _pair()
    p_default = plan_spgemm_tiled(a, b, backend="host", cache=False,
                                  device="cpu")
    assert dict(p_default.params)["profile"] == "default"

    profile.set_profile(_measured())
    p_measured = plan_spgemm_tiled(a, b, backend="host", cache=False,
                                   device="cpu")
    tag = dict(p_measured.params)["profile"]
    assert tag.startswith("measured:")
    assert p_measured.cache_key != p_default.cache_key

    p_explicit = plan_spgemm_tiled(a, b, backend="host", cache=False,
                                   device="cpu", constants=DEFAULT_CONSTANTS)
    assert dict(p_explicit.params)["profile"] == "explicit"


def test_tiled_cache_keyed_by_profile():
    """The plan LRU never hands picks ranked under one calibration to a
    call running under another."""
    from repro_torch.core.api import PLAN_CACHE, _cached_tiled_plan

    a, b = _pair()
    host = get_backend("host")
    p1 = _cached_tiled_plan(a, b, host, None, None, "cpu")
    assert _cached_tiled_plan(a, b, host, None, None, "cpu") is p1
    profile.set_profile(_measured())
    p2 = _cached_tiled_plan(a, b, host, None, None, "cpu")
    assert p2 is not p1
    assert p2.cache_key != p1.cache_key
    tags = {k[6] for k in PLAN_CACHE._plans if k[2] == "auto"}
    assert tags == {"default", profile.current_profile().tag}


def test_cached_plan_stream_limit_keys_the_lru():
    """``cached_plan(stream_limit=)`` sets one plan's guard without the
    global knob, and is part of the key."""
    from repro_torch.core import cached_plan

    a, b = _pair()
    p_default = cached_plan(a, b, "expand", backend="host")
    assert p_default.stream_limit == fast.STREAM_MAX_PRODUCTS
    p_small = cached_plan(a, b, "expand", backend="host", stream_limit=3)
    assert p_small is not p_default and p_small.stream_limit == 3
    assert cached_plan(a, b, "expand", backend="host",
                       stream_limit=3) is p_small
    # an explicit limit equal to the guard in force is the same entry
    assert cached_plan(a, b, "expand", backend="host",
                       stream_limit=fast.STREAM_MAX_PRODUCTS) is p_default
    assert plan_cache_info()["size"] == 2
    assert fast.STREAM_MAX_PRODUCTS == fast.DEFAULT_STREAM_MAX_PRODUCTS


def test_plan_cache_info_exposes_profile():
    info = plan_cache_info()["profile"]
    assert info["source"] == "default"
    for key in ("fingerprint_key", "fitted", "tuning",
                "default_auto_uses", "stale_discards", "load_errors",
                "auto_calibrations"):
        assert key in info
    profile.set_profile(_measured(fitted=("torch_base",)))
    info = plan_cache_info()["profile"]
    assert info["source"] == "measured"
    assert info["fitted"] == ["torch_base"]
    assert info["age_seconds"] is not None


# ---------------------------------------------------------------------------
# the pure functions equal the reference's
# ---------------------------------------------------------------------------


def _ref_field(name: str) -> str:
    return name.replace("torch_", "jax_")


@pytest.mark.parametrize("seed", range(4))
def test_fit_fields_and_constants_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    sections = []
    for fields in (("spa_col", "spa_entry", "spa_flop"),
                   ("stream_base", "stream_prod"),
                   ("expand_base", "expand_prod", "expand_sort"),
                   ("torch_base", "torch_prod"),
                   ("fused_base", "fused_prod")):
        k = len(fields) + int(rng.integers(1, 4))
        rows = np.column_stack(
            [np.ones(k)] + [rng.uniform(1, 1e5, size=k)
                            for _ in fields[1:]])
        times = rng.uniform(1e-6, 1e-2, size=k)   # negative fits clamp
        sections.append((fields, rows.tolist(), times.tolist()))
        got = profile.fit_fields(fields, rows, times)
        want = ref_profile.fit_fields(fields, rows, times)
        assert list(got.values()) == list(want.values())
    got_c, got_f = profile.fit_constants(sections)
    want_c, want_f = ref_profile.fit_constants(
        [(tuple(_ref_field(f) for f in fields), r, t)
         for fields, r, t in sections])
    assert sorted(_ref_field(f) for f in got_f) == sorted(want_f)
    for f in dataclasses.fields(got_c):
        assert getattr(got_c, f.name) == getattr(want_c, _ref_field(f.name))
    assert dataclasses.asdict(DEFAULT_CONSTANTS) == {
        k.replace("jax_", "torch_"): v
        for k, v in dataclasses.asdict(REF_DEFAULTS).items()}


@pytest.mark.parametrize("seed", range(6))
def test_rank_correlation_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    x = rng.integers(0, 6, size=n).astype(float)   # ties on both sides
    y = rng.standard_normal(n) if seed % 2 else rng.integers(0, 4, size=n)
    assert profile.rank_correlation(x, y) == ref_profile.rank_correlation(x, y)


@pytest.mark.parametrize("pages", [0, 1, 1 << 18, 1 << 22, 25_165_824,
                                   1 << 40, "ValueError", "OSError"])
def test_tune_stream_guard_equals_the_references(monkeypatch, pages):
    """The guard rule on the same RAM (4 KiB pages: 0 B to 4 PiB) and on a
    ``sysconf`` that fails: the reference's answer, and its fallback."""
    def sysconf(name):
        if isinstance(pages, str):
            raise {"ValueError": ValueError, "OSError": OSError}[pages](name)
        return pages if name == "SC_PHYS_PAGES" else 4096

    monkeypatch.setattr(os, "sysconf", sysconf)
    got = profile._tune_stream_guard()
    assert got == ref_profile._tune_stream_guard()
    assert fast.DEFAULT_STREAM_MAX_PRODUCTS == \
        ref_fast.DEFAULT_STREAM_MAX_PRODUCTS
    assert 1_000_000 <= got <= 64_000_000


def test_tune_stream_guard_without_sysconf(monkeypatch):
    monkeypatch.delattr(os, "sysconf")
    assert profile._tune_stream_guard() == ref_profile._tune_stream_guard() \
        == fast.DEFAULT_STREAM_MAX_PRODUCTS


# ---------------------------------------------------------------------------
# the port's own points
# ---------------------------------------------------------------------------


def test_reference_profile_in_the_same_directory_is_not_loaded(tmp_path,
                                                               monkeypatch):
    """The JAX package's profile, written into the port's directory, is
    never taken for the port's: its fingerprint has other fields, so its
    file has another name, and named explicitly it is discarded."""
    d = tmp_path / "profiles"
    ref = ref_profile.MachineProfile(
        constants=REF_DEFAULTS, fingerprint=ref_profile.machine_fingerprint(),
        source="measured", created_at=1.0, fitted=("jax_base",))
    path = ref_profile.save_profile(ref, directory=str(d))
    assert os.listdir(d) == [os.path.basename(path)]
    assert profile.load_profile(directory=str(d)) is None
    assert profile.current_profile().source == "default"
    monkeypatch.setenv("REPRO_PROFILE_FILE", path)
    profile.reset()
    with pytest.warns(RuntimeWarning, match="different machine"):
        assert profile.load_profile(directory=str(d)) is None
    assert profile.profile_info()["stale_discards"] >= 1
    # and the other way round
    monkeypatch.delenv("REPRO_PROFILE_FILE")
    profile.save_profile(_measured(), directory=str(d))
    assert ref_profile.load_profile(directory=str(d)).tag == ref.tag


def test_failing_auto_calibration_raises(monkeypatch):
    """With ``REPRO_AUTO_CALIBRATE=1`` and no profile on disk, a calibration
    that fails raises to the caller (it does not carry on on the defaults),
    and the next consult tries again."""
    monkeypatch.setenv("REPRO_AUTO_CALIBRATE", "1")

    def broken(**kw):
        assert kw == dict(scale=0.25, reps=2, save=True)
        raise RuntimeError("the card failed")

    monkeypatch.setattr(profile, "calibrate_profile", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="the card failed"):
            profile.current_profile()
    assert profile._STATE == {"profile": None, "loading": False}
    assert profile._COUNTERS["auto_calibrations"] == 0


def test_auto_calibration_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the calibration would run on it")
    monkeypatch.setenv("REPRO_AUTO_CALIBRATE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.current_profile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.calibrate_profile(sections=("spa",))


def test_auto_calibration_runs_once_and_persists(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_AUTO_CALIBRATE", "1")
    calls = []

    def fake(**kw):
        calls.append(kw)
        prof = _measured(fitted=("spa_col",))
        profile.set_profile(prof)
        return prof

    monkeypatch.setattr(profile, "calibrate_profile", fake)
    first = profile.current_profile()
    assert first.source == "measured" and profile.current_profile() is first
    assert len(calls) == 1
    assert profile.profile_info()["auto_calibrations"] == 1


def test_unknown_section_raises():
    for bad in ("jax", "pallas"):
        with pytest.raises(ValueError, match="unknown sections"):
            profile.calibrate_profile(sections=("spa", bad), device="cpu")


def test_calibration_on_the_cpu_round_trips(tmp_path):
    """The host ladders, fitted and tuned on the CPU, saved, loaded back,
    installed, and then ranking ``method="auto"`` with their tag."""
    d = str(tmp_path / "profiles")
    prof = profile.calibrate_profile(scale=0.25, reps=1, device="cpu",
                                     sections=("spa", "stream", "expand"),
                                     save=True, directory=d)
    assert prof.source == "measured"
    assert prof.fitted == ("expand_base", "expand_prod", "expand_sort",
                           "spa_col", "spa_entry", "spa_flop",
                           "stream_base", "stream_prod")
    for f in prof.fitted:
        assert getattr(prof.constants, f) >= 1e-12
    for f in ("torch_base", "torch_prod", "fused_base", "fused_prod",
              "p_spa_entry"):
        assert getattr(prof.constants, f) == getattr(DEFAULT_CONSTANTS, f)
    assert set(prof.tuning) == set(profile.TUNING_KEYS)
    assert prof.tuning["tile_n_target"] in (2048, 8192, 32768)
    assert prof.tuning["tile_k_target"] == 16 * prof.tuning["tile_n_target"]
    assert prof.tuning["stream_max_products"] == profile._tune_stream_guard()
    back = profile.load_profile(directory=d)
    assert back.tag == prof.tag and back.constants == prof.constants
    assert profile.current_profile() is prof
    assert os.path.dirname(prof.path) == d
    a, b = _pair()
    plan = plan_spgemm_tiled(a, b, backend="host", cache=False,
                             device="cpu")
    assert dict(plan.params)["profile"] == prof.tag
    # a second calibration of one section keeps the first one's fit
    again = profile.calibrate_profile(scale=0.25, reps=1, device="cpu",
                                      sections=("spa",), tune=False,
                                      directory=d)
    assert again.fitted == prof.fitted
    assert again.constants.stream_prod == prof.constants.stream_prod
    assert again.tuning == prof.tuning
