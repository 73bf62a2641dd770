"""The port's serving engine with a plan builder (the background warm and
the host-stream fallback tick) against the JAX package's, on the CPU.

Mirrors the builder tests of ``tests/test_serving_spgemm.py``: with the
warm held in flight (the builder's worker pinned behind a gate) ticks
complete on the fallback and the engine promotes once the warm lands,
with the tokens of a builder-free run, greedy and sampled (one draw of the
engine's RNG per sampled token on either tick kind); a dense engine handed
a builder has nothing to warm; many engines share one builder and
``close()`` detaches one.  Then the port against the reference: the same
greedy and sampled tokens across a mid-request promotion, on weights drawn
by the reference's ``init_model`` (rescaled to std 1/sqrt(d_in), as in
``tests/test_torch_serving.py``), its overlay carried across by
``convert.overlay_from_reference`` and its values by
``convert.model_params_from_reference``.  Every wait has a timeout.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import ARCHS as REF_ARCHS
from repro.core import PlanBuilder as RefBuilder
from repro.models import config as ref_config
from repro.models import init_model as ref_init_model
from repro.models.sparse_ffn import sparsify_ffn_params as ref_sparsify
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference, \
    overlay_from_reference
from repro_torch.core import PlanBuilder, plan_cache_clear, plan_cache_info
from repro_torch.models import init_model, model_tables, smoke
from repro_torch.models.params import Leaf
from repro_torch.models.sparse_ffn import sparsify_ffn_params
from repro_torch.serving import ServeEngine

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def small_model():
    torch.set_num_threads(1)
    cfg = smoke(get_config(ARCH))
    return cfg, init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


@pytest.fixture(scope="module")
def sparse_model(small_model):
    cfg, params = small_model
    sparse_params, overlay = sparsify_ffn_params(cfg, params,
                                                 keep_density=0.5)
    return cfg, sparse_params, overlay


def engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **kw)


def gated(builder):
    """Pin the builder's worker behind a gate; returns the gate."""
    gate = threading.Event()
    builder.submit_task(lambda: gate.wait(60), tag="gate")
    return gate


# -- the async warm protocol --------------------------------------------------------


def test_tick_completes_while_build_in_flight(sparse_model):
    """With the warm held in flight, ticks complete on the fallback; the
    engine promotes once the warm lands, with the tokens of a builder-free
    run."""
    cfg, sparse_params, overlay = sparse_model
    with PlanBuilder() as builder:
        gate = gated(builder)
        eng = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                     sparse_ffn=overlay, plan_builder=builder)
        assert not eng.sparse_ready()
        rid = eng.submit([1, 2, 3], max_new_tokens=6)
        for _ in range(3):
            assert eng.step()
        stats = eng.stats()
        assert stats["fallback_ticks"] == 3 and stats["jit_ticks"] == 0
        # one sync for the logits, five for each of the overlay FFNs
        assert stats["host_syncs"] == 3 * (1 + 5 * cfg.n_layers)
        assert not eng.sparse_ready()

        gate.set()
        assert eng.wait_sparse(120)
        done = eng.run_to_completion()
        stats = eng.stats()
        assert stats["jit_ticks"] > 0
        assert stats["host_syncs"] == 3 * (1 + 5 * cfg.n_layers) \
            + stats["jit_ticks"]
        assert stats["warm_submits"] == 1 and stats["warm_failures"] == 0
        assert stats["breaker"]["successes"] == 1
        assert stats["builder"]["completed"] == 2
    mixed = done[rid].generated
    assert len(mixed) == 6

    ref = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                 sparse_ffn=overlay)
    rid2 = ref.submit([1, 2, 3], max_new_tokens=6)
    assert ref.run_to_completion()[rid2].generated == mixed
    assert ref.stats()["fallback_ticks"] == 0
    assert set(ref.stats()) == set(stats) - {"breaker", "builder"}


def test_first_device_tick_builds_and_lifts_nothing(small_model):
    """The warm builds every plan the device tick uses and lifts its
    stream: the first device tick after promotion misses no plan (a fresh
    overlay, whose matrices have memoized no plan yet)."""
    cfg, params = small_model
    sparse_params, overlay = sparsify_ffn_params(cfg, params,
                                                 keep_density=0.4)
    plan_cache_clear()
    with PlanBuilder() as builder:
        eng = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                     sparse_ffn=overlay, plan_builder=builder)
        assert eng.wait_sparse(120)
        warm = plan_cache_info()
        assert warm["device_stream_bytes"] > 0
        eng.submit([5, 6, 7], max_new_tokens=2)
        assert eng.step()
        after = plan_cache_info()
    assert eng.stats()["jit_ticks"] == 1
    assert warm["misses"] == 3      # gate, up and down: one plan each
    assert after["misses"] == warm["misses"]
    assert after["device_stream_bytes"] == warm["device_stream_bytes"]


def test_dense_engine_unaffected_by_builder(small_model):
    """A dense engine handed a builder has nothing to warm and serves the
    device step from the first tick."""
    cfg, params = small_model
    with PlanBuilder() as builder:
        eng = engine(cfg, params, max_batch=1, cache_len=32,
                     plan_builder=builder)
        assert eng.sparse_ready()
        rid = eng.submit([5, 6], max_new_tokens=3)
        done = eng.run_to_completion()
        assert builder.stats["submitted"] == 0
    assert eng.tick_stats["fallback_ticks"] == 0
    assert "breaker" not in eng.stats()     # no warm, no breaker
    assert len(done[rid].generated) == 3


def test_sampled_decode_equivalent_across_promotion(sparse_model):
    """Sampled serving across the promotion: the same seed gives the same
    tokens whether ticks ran on the fallback, the device, or a mix (both
    tick kinds draw the engine's RNG once per sampled token)."""
    cfg, sparse_params, overlay = sparse_model
    with PlanBuilder() as builder:
        gate = gated(builder)
        eng = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                     sparse_ffn=overlay, plan_builder=builder, seed=123)
        rid = eng.submit([1, 2, 3], max_new_tokens=8, temperature=0.7)
        for _ in range(4):
            assert eng.step()
        assert eng.tick_stats["fallback_ticks"] == 4
        gate.set()
        assert eng.wait_sparse(120)
        done = eng.run_to_completion()
        assert eng.tick_stats["jit_ticks"] > 0
    mixed = done[rid].generated

    def run(seed):
        e = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                   sparse_ffn=overlay, seed=seed)
        r = e.submit([1, 2, 3], max_new_tokens=8, temperature=0.7)
        return e.run_to_completion()[r].generated

    assert run(123) == mixed
    assert run(124) != mixed    # the test has teeth


def test_many_engines_share_one_builder(small_model, sparse_model):
    """Engines on one builder: an engine becomes ready only through its own
    warm, each engine's greedy output equals a solo builder-free run, and
    closing one leaves the builder serving the others."""
    cfg, sparse_params, overlay = sparse_model
    _, params = small_model
    sparse_params3, overlay3 = sparsify_ffn_params(cfg, params,
                                                   keep_density=0.25)
    prompts = {1: [1, 2, 3], 2: [4, 5], 3: [6, 7, 8]}
    with PlanBuilder() as builder:
        eng1 = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                      sparse_ffn=overlay, plan_builder=builder)
        assert eng1.wait_sparse(120)
        gate = gated(builder)
        eng2 = engine(cfg, sparse_params, max_batch=2, cache_len=32,
                      sparse_ffn=overlay, plan_builder=builder)
        assert eng1.sparse_ready() and not eng2.sparse_ready()
        gate.set()
        eng3 = engine(cfg, sparse_params3, max_batch=2, cache_len=32,
                      sparse_ffn=overlay3, plan_builder=builder)
        engines = {1: eng1, 2: eng2, 3: eng3}
        rids = {i: e.submit(prompts[i], max_new_tokens=5)
                for i, e in engines.items()}
        for _ in range(200):
            if not any(e.queue or any(e.slots) for e in engines.values()):
                break
            for e in engines.values():
                if e.queue or any(e.slots):
                    e.step()
        gens = {i: e.finished[rids[i]].generated
                for i, e in engines.items()}
        eng1.close()
        builder.submit_task(lambda: "alive", tag="alive")
        assert builder.wait_idle(120)
        assert any(r.tag == "alive" and r.ok for r in builder.poll())

    for i, (model, ovl) in {1: (sparse_params, overlay),
                            2: (sparse_params, overlay),
                            3: (sparse_params3, overlay3)}.items():
        ref = engine(cfg, model, max_batch=2, cache_len=32, sparse_ffn=ovl)
        rid = ref.submit(prompts[i], max_new_tokens=5)
        assert ref.run_to_completion()[rid].generated == gens[i], i
        assert len(gens[i]) == 5


# -- against the reference's engine ----------------------------------------------


def _well_scaled(cfg, tree):
    """Stacked fan-in leaves rescaled to std 1/sqrt(d_in)."""
    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return (p * (t.shape[0] / t.shape[-2]) ** 0.5).astype(
                    np.float32)
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), tree)


@pytest.fixture(scope="module")
def both_models():
    """(cfg, port sparse params, port overlay, ref cfg, ref sparse params,
    ref overlay): the reference's weights and masks in both packages."""
    cfg = smoke(get_config(ARCH))
    ref_cfg = ref_config.smoke(REF_ARCHS[ARCH])
    tree = jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_cfg, jax.random.PRNGKey(3)))
    tree = _well_scaled(cfg, tree)
    ref_params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    ref_sp, ref_ov = ref_sparsify(ref_cfg, ref_params, keep_density=0.5)
    sp = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_sp), device="cpu")
    return cfg, sp, overlay_from_reference(ref_ov, device="cpu"), ref_cfg, \
        ref_sp, ref_ov


PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8])


def _gated_run(eng, builder, gate, prompts, new, temperature, n_fallback):
    """Submit ``prompts``, run ``n_fallback`` ticks with the warm gated,
    release it, wait for the promotion, run to the end."""
    rids = [eng.submit(p, max_new_tokens=new, temperature=temperature)
            for p in prompts]
    for _ in range(n_fallback):
        assert eng.step()
    gate.set()
    assert eng.wait_sparse(120)
    done = eng.run_to_completion()
    assert builder.wait_idle(60)
    return [done[r].generated for r in rids], dict(eng.tick_stats)


@pytest.mark.parametrize("temperature, seed", [(0.0, 0), (0.7, 5)])
def test_tokens_across_promotion_equal_the_references(both_models,
                                                      temperature, seed):
    """Both engines promote mid-request after the same fallback ticks: the
    same greedy (and, at one seed, sampled) tokens, and the same tick
    counts."""
    cfg, sp, ov, ref_cfg, ref_sp, ref_ov = both_models
    with PlanBuilder() as builder:
        gate = gated(builder)
        eng = engine(cfg, sp, max_batch=2, cache_len=32, sparse_ffn=ov,
                     plan_builder=builder, seed=seed)
        got, stats = _gated_run(eng, builder, gate, PROMPTS, 5, temperature,
                                3)
    with RefBuilder() as ref_builder:
        ref_gate = threading.Event()
        ref_builder.submit_task(lambda: ref_gate.wait(60), tag="gate")
        ref_eng = RefEngine(ref_cfg, ref_sp, max_batch=2, cache_len=32,
                            sparse_ffn=ref_ov, plan_builder=ref_builder,
                            seed=seed)
        want, ref_stats = _gated_run(ref_eng, ref_builder, ref_gate, PROMPTS,
                                     5, temperature, 3)
    assert got == want
    assert all(len(g) == 5 for g in got)
    for key in ("jit_ticks", "fallback_ticks", "warm_submits",
                "warm_failures", "health"):
        assert stats[key] == ref_stats[key], key
    assert stats["fallback_ticks"] == 3


def test_sparse_inference_example_runs_on_the_host(capsys):
    """``examples/torch_sparse_inference.py --device cpu``: the policy's
    paths by keep and six requests served on three slots."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_sparse_inference.py")
    spec = importlib.util.spec_from_file_location("torch_sparse_inference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert " 0.90  dense" in out and " 0.25    bsr" in out
    assert "served 6 requests on 3 slots" in out
