"""The port's serving engine (``repro_torch.serving.ServeEngine``, the
synchronous path: no plan builder) against the JAX package's, on the CPU.

Mirrors ``tests/test_serving.py`` (continuous batching, per-slot cache
lengths, EOS, slot isolation, the engine against a raw ``decode_step``
loop) and the builder-free tests of ``tests/test_serving_spgemm.py`` (the
request bounds, the spgemm FFN overlay served synchronously), then holds
the engine against the reference's engine with the same prompts on the
``qwen2-0.5b``, ``llama-3.2-vision-90b`` and ``seamless-m4t-large-v2``
smoke models: the same greedy tokens, every tick's logits within
MODEL_TOL = 1e-5 normwise (C9; measured at most 8.7e-7), and sampling's
tokens equal on equal logits and seed.  C11: the reference's engine
installs whatever ``aux`` it is given as the memory, so for encdec it
equals ``prefill`` only on ``_memory_from_aux``'s output.

Weights are drawn by the reference's ``init_model``, every ``xgate`` set
non-zero, and (for the comparisons of logits) rescaled to std 1/sqrt(d_in)
as in ``tests/test_torch_models_cross.py``, then carried across by
``convert.model_params_from_reference``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import init_model as ref_init_model
from repro.models.lm import _memory_from_aux as ref_memory_from_aux
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models import decode_step, decode_step_loop, init_cache, \
    model_tables, prefill, smoke
from repro_torch.models.layers import lm_logits
from repro_torch.models.lm import _memory_from_aux
from repro_torch.models.params import Leaf
from repro_torch.models.sparse_ffn import densify_ffn_params, \
    sparsify_ffn_params
from repro_torch.serving import Request, ServeEngine

MODEL_TOL = 1e-5
DECODE_TOL = 5e-5
CROSS = ("llama-3.2-vision-90b", "seamless-m4t-large-v2")


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _well_scaled(cfg, tree):
    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return (p * (t.shape[0] / t.shape[-2]) ** 0.5).astype(
                    np.float32)
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), tree)


def _model(arch, scaled=True, seed=0):
    cfg, ref_cfg = smoke(get_config(arch)), ref_config.smoke(REF_ARCHS[arch])
    tree = jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_cfg, jax.random.PRNGKey(seed)))
    for sub in tree["blocks"].values():
        if "xgate" in sub:
            sub["xgate"] = np.full_like(sub["xgate"], 0.7)
    if scaled:
        tree = _well_scaled(cfg, tree)
    return (cfg, ref_cfg, model_params_from_reference(tree, device="cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


_MODELS = {}


def model(arch, scaled=True):
    """(cfg, ref_cfg, params, ref_params), built once per module."""
    if (arch, scaled) not in _MODELS:
        _MODELS[arch, scaled] = _model(arch, scaled)
    return _MODELS[arch, scaled]


def frames(cfg, b, seed=1) -> np.ndarray:
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    return np.random.default_rng(seed).normal(
        size=(b, n, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def small_model():
    cfg, _, params, _ = model("qwen2-0.5b", scaled=False)
    return cfg, params


def engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **kw)


# -- tests/test_serving.py --------------------------------------------------


def test_engine_completes_requests(small_model):
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=2, cache_len=64)
    rids = [eng.submit([1, 2, 3], max_new_tokens=5) for _ in range(4)]
    done = eng.run_to_completion()
    assert set(done) == set(rids)
    for r in done.values():
        assert len(r.generated) == 5 and r.done
        assert all(0 <= t < cfg.vocab for t in r.generated)


def test_engine_greedy_deterministic(small_model):
    cfg, params = small_model
    outs = []
    for _ in range(2):
        eng = engine(cfg, params, max_batch=2, cache_len=64)
        eng.submit([5, 6, 7, 8], max_new_tokens=6)
        done = eng.run_to_completion()
        outs.append(list(done.values())[0].generated)
    assert outs[0] == outs[1]


def test_engine_continuous_batching_matches_solo(small_model):
    """A request decoded alongside others == decoded alone (slot
    isolation)."""
    cfg, params = small_model
    solo = engine(cfg, params, max_batch=1, cache_len=64)
    solo.submit([9, 10, 11], max_new_tokens=4)
    ref = list(solo.run_to_completion().values())[0].generated

    eng = engine(cfg, params, max_batch=3, cache_len=64)
    eng.submit([1, 2], max_new_tokens=8)       # staggered neighbour
    eng.step()
    eng.step()
    rid = eng.submit([9, 10, 11], max_new_tokens=4)
    done = eng.run_to_completion()
    assert done[rid].generated == ref


def test_engine_eos_stops(small_model):
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=1, cache_len=64)
    probe = engine(cfg, params, max_batch=1, cache_len=64)
    probe.submit([3, 4], max_new_tokens=1)
    eos = list(probe.run_to_completion().values())[0].generated[0]
    eng.submit([3, 4], max_new_tokens=10, eos_id=eos)
    done = eng.run_to_completion()
    assert len(list(done.values())[0].generated) == 1


def test_engine_decode_matches_model_decode(small_model):
    """Engine pathway == raw decode_step loop (greedy, single slot)."""
    cfg, params = small_model
    prompt = [11, 12, 13, 14]
    eng = engine(cfg, params, max_batch=1, cache_len=64)
    eng.submit(prompt, max_new_tokens=3)
    got = list(eng.run_to_completion().values())[0].generated

    cache = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    toks = list(prompt)
    for t in range(len(prompt) + 2):
        logits, cache = decode_step(params, cfg, torch.tensor([[toks[t]]]),
                                    cache, torch.tensor([t],
                                                        dtype=torch.int32))
        if t >= len(prompt) - 1:
            toks.append(int(logits[0, 0, :cfg.vocab].argmax()))
    assert toks[len(prompt):] == got


# -- tests/test_serving_spgemm.py, without the plan builder --------------------


def test_empty_prompt_rejected_at_submit(small_model):
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=1, cache_len=32)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])
    assert not eng.queue


def test_oversize_prompt_rejected_at_submit(small_model):
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=1, cache_len=16)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(list(range(16)))
    assert not eng.queue


def test_prompt_exactly_cache_minus_one(small_model):
    """The largest admissible prompt prefills fully and still produces a
    token before the slot retires at the cache bound."""
    cfg, params = small_model
    cache_len = 16
    eng = engine(cfg, params, max_batch=1, cache_len=cache_len)
    rid = eng.submit(list(range(1, cache_len)), max_new_tokens=8)
    req = eng.run_to_completion()[rid]
    assert len(req.generated) == 1 and req.done


def test_eos_on_first_sampled_token(small_model):
    cfg, params = small_model
    probe = engine(cfg, params, max_batch=1, cache_len=32)
    probe.submit([3, 4], max_new_tokens=1)
    eos = list(probe.run_to_completion().values())[0].generated[0]
    eng = engine(cfg, params, max_batch=1, cache_len=32)
    rid = eng.submit([3, 4], max_new_tokens=10, eos_id=eos)
    done = eng.run_to_completion()
    assert done[rid].generated == [eos] and done[rid].done


def test_slot_reuse_is_deterministic(small_model):
    """A slot freed by a finished request serves the next with no state
    leaking from the previous occupant."""
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=1, cache_len=32)
    rids = [eng.submit([7, 8, 9], max_new_tokens=4) for _ in range(3)]
    done = eng.run_to_completion()
    gens = [done[r].generated for r in rids]
    assert gens[0] == gens[1] == gens[2]


def test_cache_bound_bypassed_raises(small_model):
    cfg, params = small_model
    eng = engine(cfg, params, max_batch=1, cache_len=8)
    eng.slots[0] = Request(99, [1, 2])
    eng.cur_len[0] = 8
    with pytest.raises(AssertionError, match="past its KV cache"):
        eng.step()


@pytest.fixture(scope="module")
def sparse_model(small_model):
    cfg, params = small_model
    sparse, overlay = sparsify_ffn_params(cfg, params, keep_density=0.5)
    return cfg, sparse, overlay


def test_sparse_decode_matches_dense_reference(sparse_model):
    """decode_step with the spgemm overlay == decode_step on the densified
    weights, and the host-stream spelling == the device one."""
    cfg, sparse, overlay = sparse_model
    dense = densify_ffn_params(cfg, sparse, overlay)
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    tok = torch.tensor([[3], [5]])
    cur = torch.zeros(2, dtype=torch.int32)
    ref, _ = decode_step(dense, cfg, tok, cache, cur)
    got, _ = decode_step(sparse, cfg, tok, cache, cur, sparse_ffn=overlay)
    loop, _ = decode_step_loop(sparse, cfg, tok, cache, cur,
                               sparse_ffn=overlay, sparse_host=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(loop.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sparse_engine_plain_serving(sparse_model):
    """The engine serves the overlay synchronously (its first tick builds
    the plans), every tick on the device step, and its tokens equal the
    engine's on the densified weights."""
    cfg, sparse, overlay = sparse_model
    eng = engine(cfg, sparse, max_batch=2, cache_len=32, sparse_ffn=overlay)
    rid = eng.submit([1, 2, 3], max_new_tokens=4)
    done = eng.run_to_completion()
    assert len(done[rid].generated) == 4
    assert all(0 <= t < cfg.vocab for t in done[rid].generated)
    stats = eng.stats()
    assert stats["fallback_ticks"] == 0
    assert stats["jit_ticks"] == stats["host_syncs"] == 6
    dense = engine(cfg, densify_ffn_params(cfg, sparse, overlay),
                   max_batch=2, cache_len=32)
    dense.submit([1, 2, 3], max_new_tokens=4)
    assert list(dense.run_to_completion().values())[0].generated \
        == done[rid].generated


# -- against the reference's engine --------------------------------------------


def _spy(ref_eng, log):
    """Record the reference engine's logits tick by tick."""
    step = ref_eng._step

    def spied(*args):
        out = step(*args)
        log.append(np.asarray(out[0][:, 0, :ref_eng.cfg.vocab], np.float32))
        return out

    ref_eng._step = spied


def _record(eng):
    """The port engine's host logits, tick by tick (its ``_decode``)."""
    log, decode = [], eng._decode

    def spied(toks):
        log.append(decode(toks))
        return log[-1]

    eng._decode = spied
    return log


def _serve_both(eng, ref_eng, prompts, max_new, temperature=0.0):
    """The same schedule on both engines (the first request alone for two
    ticks, then the rest), tick by tick: the normwise error of each tick's
    logits, and each engine's finished requests' tokens."""
    log, errs = [], []
    _spy(ref_eng, log)
    got = _record(eng)
    for e in (eng, ref_eng):
        e.submit(prompts[0], max_new_tokens=max_new,
                 temperature=temperature)
    for _ in range(2):
        eng.step()
        ref_eng.step()
        errs.append(normwise(got[-1], log[-1]))
    for e in (eng, ref_eng):
        for p in prompts[1:]:
            e.submit(p, max_new_tokens=max_new, temperature=temperature)
    while eng.queue or any(eng.slots):
        assert ref_eng.queue or any(ref_eng.slots)
        eng.step()
        ref_eng.step()
        errs.append(normwise(got[-1], log[-1]))
    assert not (ref_eng.queue or any(ref_eng.slots))
    return (errs, {k: r.generated for k, r in eng.finished.items()},
            {k: r.generated for k, r in ref_eng.finished.items()})


PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11])


@pytest.mark.parametrize("arch", ("qwen2-0.5b",) + CROSS)
def test_engine_matches_the_reference_engine(arch):
    """Three slots, four requests (one waits for a slot), staggered starts;
    for encdec both engines get their own package's encoder output as the
    memory, for vlm the same patch embeddings."""
    cfg, ref_cfg, params, ref_params = model(arch)
    aux = ref_aux = None
    if cfg.family in ("vlm", "encdec"):
        x = frames(cfg, 3)
        aux = _memory_from_aux(params, cfg, torch.from_numpy(x))
        ref_aux = ref_memory_from_aux(ref_params, ref_cfg, jnp.asarray(x))
    eng = engine(cfg, params, max_batch=3, cache_len=32, aux=aux)
    ref_eng = RefEngine(ref_cfg, ref_params, max_batch=3, cache_len=32,
                        aux=ref_aux)
    errs, got, want = _serve_both(eng, ref_eng, PROMPTS, 5)
    assert got == want
    assert len(got) == len(PROMPTS)
    assert max(errs) <= MODEL_TOL, errs
    assert set(eng.stats()) == set(ref_eng.tick_stats) | {"host_syncs"}
    assert eng.stats()["jit_ticks"] == ref_eng.tick_stats["jit_ticks"] \
        == len(errs) == eng.stats()["host_syncs"]


@pytest.mark.parametrize("seed", [0, 7])
def test_sampling_takes_the_references_token(seed):
    """The same logits and seed give the same sampled tokens: both engines'
    device steps replaced by one that returns the same logits a tick."""
    cfg, ref_cfg, params, ref_params = model("qwen2-0.5b", scaled=False)
    rng = np.random.default_rng(seed + 100)
    table = [rng.normal(size=(3, cfg.vocab)).astype(np.float32) * 3
             for _ in range(40)]
    eng = engine(cfg, params, max_batch=3, cache_len=32, seed=seed)
    ref_eng = RefEngine(ref_cfg, ref_params, max_batch=3, cache_len=32,
                        seed=seed)
    tick = {"port": 0, "ref": 0}

    def port_decode(toks):
        tick["port"] += 1
        return table[tick["port"] - 1]

    def ref_step(p, t, c, l):
        tick["ref"] += 1
        pad = np.full((3, 1, cfg.vocab_padded), -1e30, np.float32)
        pad[:, 0, :cfg.vocab] = table[tick["ref"] - 1]
        return jnp.asarray(pad), c

    eng._decode = port_decode
    ref_eng._step = ref_step
    for e in (eng, ref_eng):
        for p, temp in zip(PROMPTS, (0.8, 1.0, 0.0, 1.7)):
            e.submit(p, max_new_tokens=6, temperature=temp)
    got = {k: r.generated for k, r in eng.run_to_completion().items()}
    want = {k: r.generated for k, r in ref_eng.run_to_completion().items()}
    assert got == want and tick["port"] == tick["ref"]
    assert len({t for g in got.values() for t in g}) > 6


def test_encdec_engine_memory_is_the_references_contract():
    """C11.  The engine installs the ``aux`` it is given: on the raw frame
    embeddings the port's engine equals the reference's (tokens and each
    tick's logits) and differs from ``prefill``, which encodes the frames;
    on ``_memory_from_aux``'s output it equals ``prefill`` at every
    position."""
    cfg, ref_cfg, params, ref_params = model(CROSS[1])
    x = frames(cfg, 2, seed=5)
    raw = engine(cfg, params, max_batch=2, cache_len=32,
                 aux=torch.from_numpy(x))
    ref_raw = RefEngine(ref_cfg, ref_params, max_batch=2, cache_len=32,
                        aux=jnp.asarray(x))
    prompts = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8])
    errs, got, want = _serve_both(raw, ref_raw, prompts, 4)
    assert got == want and max(errs) <= MODEL_TOL

    enc = engine(cfg, params, max_batch=2, cache_len=32,
                 aux=_memory_from_aux(params, cfg, torch.from_numpy(x)))
    for p in prompts:
        enc.submit(p, max_new_tokens=4)
    seqs = {}
    raw_errs, enc_errs = [], []
    raw = engine(cfg, params, max_batch=2, cache_len=32,
                 aux=torch.from_numpy(x))
    for p in prompts:
        raw.submit(p, max_new_tokens=4)
    logs, enc_log, raw_log = [], _record(enc), _record(raw)
    while enc.queue or any(enc.slots):
        live = [(b, int(enc.cur_len[b])) for b, r in enumerate(enc.slots)
                if r is not None]
        enc.step()
        raw.step()
        logs.append((live, enc_log[-1], raw_log[-1]))
    for rid, r in enc.finished.items():
        seqs[rid - 1] = r.prompt + r.generated
    tok = torch.tensor([seqs[b][:11] for b in range(2)])
    full = lm_logits(params["unembed"], cfg, prefill(
        params, cfg, tok, torch.from_numpy(x)))[..., :cfg.vocab]
    for live, enc_l, raw_l in logs:
        for b, pos in live:
            enc_errs.append(normwise(enc_l[b], full[b, pos].numpy()))
            raw_errs.append(normwise(raw_l[b], full[b, pos].numpy()))
    assert max(enc_errs) <= DECODE_TOL, enc_errs
    assert min(raw_errs) > 1e-2, raw_errs


def test_install_memory_projects_every_rep():
    """``xk``/``xv`` of each cross sub-layer: the memory through the rep's
    ``xattn.wk``/``wv``; the other sub-layers' caches stay zero, and a tick
    passes the memory's K/V through without a copy."""
    cfg, _, params, _ = model(CROSS[0])
    x = torch.from_numpy(frames(cfg, 2))
    eng = engine(cfg, params, max_batch=2, cache_len=8, aux=x)
    kinds_cross = [k for k, sub in params["blocks"].items()
                   if "xattn" in sub]
    assert kinds_cross == ["l1"]
    w = params["blocks"]["l1"]["xattn"]["wk"]["w"]
    shape = (2, cfg.n_image_tokens, cfg.n_kv_heads, cfg.d_head)
    for r in range(w.shape[0]):
        assert torch.equal(eng.cache["l1"]["xk"][r],
                           (x @ w[r]).reshape(shape))
    assert not eng.cache["l0"]["k"].any()
    xk = eng.cache["l1"]["xk"]
    eng.submit([1, 2], max_new_tokens=2)
    eng.step()
    assert eng.cache["l1"]["xk"] is xk and eng.cache["l0"]["k"].any()


def test_engine_checks_its_device_and_memory():
    cfg, _, params, _ = model(CROSS[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params)
    meta = jax.tree_util.tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="params lie on meta"):
        engine(cfg, meta)
    x = frames(cfg, 2)
    with pytest.raises(ValueError, match="aux must be a tensor"):
        engine(cfg, params, max_batch=2, aux=x)
    with pytest.raises(ValueError, match="expected"):
        engine(cfg, params, max_batch=3, aux=torch.from_numpy(x))
    eng = engine(cfg, params, max_batch=2, cache_len=8)
    assert eng.stats() == {"jit_ticks": 0, "fallback_ticks": 0,
                           "warm_submits": 0, "warm_failures": 0,
                           "health": "healthy", "host_syncs": 0}
