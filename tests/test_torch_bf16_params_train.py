"""The port on bf16 params against the JAX package's, on the CPU, second
part (``tests/test_torch_bf16_params.py`` has the draws, the conversion
and the six families): train steps, AdamW's update of a bf16 param, the
spgemm FFN overlay's decode, the serving engine's ticks and a bf16 train
state's checkpoint.

Weights are the reference's draw at smoke size, well scaled
(``torch_training_parity.family_model``), rounded to bf16 by XLA and
carried across by ``convert``; both packages start from one state.

Tolerances.  The train steps run the dry run's train settings
(``accum_steps=2``, a bf16 accumulation buffer, 8-bit moments).  The two
packages' bf16 forward passes round differently (C23: ``silu``), so their
losses agree to LOSS_RTOL = 1e-3 relative (measured 7.6e-5 for qwen2,
5.9e-4 for qwen3-moe, whose router can pick another of two near-tied
experts) and their gradients to a few bf16 ulps; AdamW's first step
moves most elements by about ``lr`` whatever the gradient, so the params
after one step are held at PARAM_TOL = 5e-3 normwise (measured 8.6e-4
and 2.4e-3, against a move of 6.2e-3 and 5.8e-3) and must lie closer to
each other than to where they started.  AdamW on bf16 params alone, on
the same gradients, computes in f32 and rounds once: equal but where its
two f32 results, which agree to a few f32 ulps, straddle a bf16 rounding
boundary, one bf16 ulp apart there, at most STRADDLE = 1e-3 of the
elements (measured 1 of 2304).  The overlay decode and the engine's
ticks keep the six families' rule (``BF16_TOL`` between the two
packages, ``RATIO`` and ``SLACK`` against each one's f32 run; measured
at most 1.1e-2 and 1.4e-2); the engine's greedy tokens are the reference
engine's up to the first near tie of two bf16 logits (the test's
docstring).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import decode_step as ref_decode_step
from repro.models.lm import _memory_from_aux as ref_memory_from_aux
from repro.models.sparse_ffn import sparsify_ffn_params as ref_sparsify
from repro.serving import ServeEngine as RefEngine
from repro.training import TrainConfig as RefTrainConfig
from repro.training import adamw_init as ref_adamw_init
from repro.training import adamw_update as ref_adamw_update
from repro.training import build_train_step as ref_build_train_step
from repro.training import synth_batch as ref_synth_batch
from repro.training.data import DataConfig as RefDataConfig
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.convert import bf16_from_reference, \
    model_params_from_reference, train_state_from_reference
from repro_torch.distributed.sharding import param_sharding, \
    sharding_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, init_cache, model_specs, \
    sparsify_ffn_params
from repro_torch.serving import ServeEngine
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, \
    adamw_init, adamw_update, build_train_step, restore_checkpoint, \
    save_checkpoint, synth_batch
from repro_torch.training.tree import tree_map, tree_paths
from test_torch_bf16_params import BF16_TOL, RATIO, SLACK, bf16_tree, \
    widened
from torch_training_parity import batch_for, family_model, normwise, \
    one_thread  # noqa: F401

LOSS_RTOL = 1e-3
PARAM_TOL = 5e-3
STRADDLE = 1e-3


def _flat(paths: dict) -> np.ndarray:
    """A tree's leaves (tensors or arrays), by key, as one f64 vector."""
    def f64(a):
        return np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                          np.float64)

    return np.concatenate([np.ravel(f64(paths[k])) for k in sorted(paths)])


def _bf16_state(arch, tc_kw):
    """(cfg, ref_cfg, port state, reference state, both configs) on the
    well-scaled draw rounded to bf16, zero moments."""
    cfg, ref_cfg, tree = family_model(arch)
    tc = TrainConfig(**tc_kw, opt=AdamWConfig(quantize_moments=True))
    ref_tc = RefTrainConfig(**tc_kw,
                            opt=RefAdamWConfig(quantize_moments=True))
    ref_state = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  bf16_tree(tree))}
    ref_state["opt"] = ref_adamw_init(ref_state["params"], ref_tc.opt)
    state = train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state), device="cpu")
    return cfg, ref_cfg, state, ref_state, tc, ref_tc


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b"])
def test_train_step_on_bf16_params_matches_the_reference(arch):
    """One step of the dry run's train settings against the reference's
    jitted step: bf16 params in and out, an f32 loss within LOSS_RTOL, the
    params within PARAM_TOL normwise and 8-bit moments."""
    kw = dict(total_steps=10, accum_steps=2, accum_dtype="bfloat16",
              peak_lr=1e-3, warmup_steps=2)
    cfg, ref_cfg, state, ref_state, tc, ref_tc = _bf16_state(arch, kw)
    before = _flat(tree_paths(state["params"]))
    dcfg = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    batch = synth_batch(DataConfig(**dcfg), 0)
    state, m = build_train_step(cfg, tc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    ref_state, ref_m = jax.jit(ref_build_train_step(ref_cfg, ref_tc))(
        ref_state, {k: jnp.asarray(v) for k, v in ref_synth_batch(
            RefDataConfig(**dcfg), 0).items()}, jnp.int32(0))
    assert m["loss"].dtype == torch.float32
    assert abs(float(m["loss"]) - float(ref_m["loss"])) <= LOSS_RTOL * abs(
        float(ref_m["loss"]))
    got = tree_paths(state["params"])
    want = tree_paths(jax.tree_util.tree_map(np.asarray,
                                             ref_state["params"]))
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    apart = normwise(_flat(got), _flat(want))
    assert apart <= PARAM_TOL and apart < normwise(_flat(got), before)
    assert {t.dtype for t in tree_paths(state["opt"]).values()} == {
        torch.int32, torch.int8, torch.float32}


def test_adamw_on_bf16_params_rounds_the_f32_update_once():
    """Three updates of bf16 params (matrices with 8-bit moments, vectors
    with f32 ones) on the same bf16 gradients: the f32 update rounded once
    to bf16, as the reference's ``astype(p.dtype)``, equal to the
    reference's; the global norm in f32."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 24, 32)), "v": rng.normal(size=(40,)),
              "m": rng.normal(size=(16, 8))}
    grads = [tree_map(lambda p: 0.1 * rng.normal(size=p.shape), params)
             for _ in range(3)]
    params, grads = bf16_tree(params), [bf16_tree(g) for g in grads]
    for quantize in (False, True):
        kw = dict(lr=1e-2, quantize_moments=quantize, grad_clip=1.0)
        cfg, ref_cfg = AdamWConfig(**kw), RefAdamWConfig(**kw)
        p = model_params_from_reference(params, device="cpu")
        state = adamw_init(p, cfg)
        rp = tree_map(jnp.asarray, params)
        rstate = ref_adamw_init(rp, ref_cfg)
        for g in grads:
            p, state = adamw_update(
                model_params_from_reference(g, device="cpu"), state, p,
                cfg, 1e-2)
            rp, rstate = ref_adamw_update(tree_map(jnp.asarray, g), rstate,
                                          rp, ref_cfg, 1e-2)
        for k, t in tree_paths(p).items():
            assert t.dtype == torch.bfloat16, k
            got = t.float().numpy()
            want = np.asarray(tree_paths(rp)[k], np.float32)
            off = got != want
            assert off.mean() <= STRADDLE, (k, off.sum())
            assert np.all(np.abs(got - want)[off]
                          <= 2.0 ** -7 * np.abs(want[off])), k


# -- the overlay and the engine ---------------------------------------------


def _overlay_logits(cfg, ref_cfg, sp, ov, ref_sp, ref_ov, tok):
    """Each package's logits over ``tok.shape[1]`` decode steps at B = 2
    from an f32 cache, through its overlay."""
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    ref_cache = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), cache)
    step = jax.jit(lambda p, tk, c, i: ref_decode_step(
        p, ref_cfg, tk, c, i, sparse_ffn=ref_ov))
    port, ref = [], []
    for t in range(tok.shape[1]):
        lg, cache = decode_step(sp, cfg,
                                torch.from_numpy(tok[:, t:t + 1]).long(),
                                cache, t, sparse_ffn=ov)
        rl, ref_cache = step(ref_sp, jnp.asarray(tok[:, t:t + 1]),
                             ref_cache, jnp.int32(t))
        port.append(lg.numpy()[..., :cfg.vocab])
        ref.append(np.asarray(rl)[..., :cfg.vocab])
    return port, ref


def test_overlay_decode_on_bf16_params_matches_the_reference():
    """``sparsify_ffn_params`` on bf16 params: the reference's patterns,
    f32 value stacks equal to the bf16 weights' values; ``apply_values``
    widens a bf16 activation and returns f32; three decode steps through
    the overlay against the reference's, each held to the families'
    rule against its own f32 run."""
    cfg, ref_cfg, tree = family_model("qwen2-0.5b")
    b16 = bf16_tree(tree)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 3)).astype(
        np.int32)
    logs = {"port": {}, "ref": {}}
    for name, t in (("bf16", b16), ("f32", widened(b16))):
        params = model_params_from_reference(t, device="cpu")
        sp, ov = sparsify_ffn_params(cfg, params, keep_density=0.5)
        ref_sp, ref_ov = ref_sparsify(
            ref_cfg, jax.tree_util.tree_map(jnp.asarray, t),
            keep_density=0.5)
        for li in ov:
            for mat in ("gate", "up", "down"):
                got, want = getattr(ov[li], mat).w_csc, \
                    getattr(ref_ov[li], mat).w_csc
                np.testing.assert_array_equal(got.col_ptr, want.col_ptr)
                np.testing.assert_array_equal(
                    got.row_indices, np.asarray(want.row_indices)[:got.nnz])
                v = sp["blocks"][li]["ffn"][mat]
                assert v.dtype == torch.float32
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(ref_sp["blocks"][li]["ffn"][mat]))
        assert sp["blocks"]["l0"]["attn"]["wq"]["w"].dtype == \
            params["embed"]["embedding"].dtype
        if name == "bf16":
            x = torch.randn((cfg.d_model, 3)).to(torch.bfloat16)
            m = ov["l0"].gate
            y = m.apply_values(sp["blocks"]["l0"]["ffn"]["gate"][0], x)
            assert y.dtype == torch.float32
            assert torch.equal(y, m.apply_values(
                sp["blocks"]["l0"]["ffn"]["gate"][0], x.float()))
        logs["port"][name], logs["ref"][name] = _overlay_logits(
            cfg, ref_cfg, sp, ov, ref_sp, ref_ov, tok)
    for t in range(tok.shape[1]):
        port, ref = ({n: lg[t] for n, lg in logs[pkg].items()}
                     for pkg in ("port", "ref"))
        assert normwise(port["bf16"], ref["bf16"]) <= BF16_TOL, t
        assert normwise(port["bf16"], port["f32"]) <= RATIO * normwise(
            ref["bf16"], ref["f32"]) + SLACK, t


def _serve(eng, prompts, max_new, log_of):
    """Every request submitted at once, ticked to the end: the tokens and
    each tick's logits."""
    log = log_of(eng)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    eng.run_to_completion()
    return {k: r.generated for k, r in eng.finished.items()}, log


def _port_log(eng):
    log, decode = [], eng._decode

    def spied(toks):
        log.append(decode(toks))
        return log[-1]

    eng._decode = spied
    return log


def _ref_log(eng):
    log, step = [], eng._step

    def spied(*args):
        out = step(*args)
        log.append(np.asarray(out[0][:, 0, :eng.cfg.vocab], np.float32))
        return out

    eng._step = spied
    return log


def _first_flip(log, ref_log):
    """The first tick at which a slot's greedy token differs between the
    two engines' logits, and whether the reference's top-2 margin there
    is within the two logits' largest difference (a near tie); None when
    no tick differs."""
    for t, (g, w) in enumerate(zip(log, ref_log)):
        flips = np.nonzero(g.argmax(-1) != w.argmax(-1))[0]
        if len(flips):
            b = flips[0]
            top = np.sort(w[b])[-2:]
            return t, bool(top[1] - top[0] <= np.abs(g[b] - w[b]).max())
    return None


@pytest.mark.parametrize("arch,equal", [("qwen2-0.5b", True),
                                        ("llama-3.2-vision-90b", True),
                                        ("seamless-m4t-large-v2", False)])
def test_engine_on_bf16_params_matches_the_reference_engine(arch, equal):
    """Three slots of 32 (an f32 cache, as the reference's), four requests
    of five new tokens on bf16 params.  The cross families' memory is
    bf16, the same in both engines (the VLM's patch embeddings; the
    reference encoder's output on bf16 frames, carried across exactly:
    each package's own encoder rounds differently, C23), its projections
    cast to the f32 cache as the reference casts them.

    bf16 logits are a bf16 product widened, 8 bits, so two tokens often
    tie, and C23's roundings can then pick the other one; after that the
    two engines decode different text.  qwen2 and the VLM meet no near
    tie here: the reference engine's greedy tokens, every tick's logits
    within BF16_TOL.  seamless meets one (measured at its fourth tick: a
    top-2 margin of 0.0156 against a logits difference of 0.033): every
    tick before the first flip within BF16_TOL, and the flip at a near
    tie."""
    cfg, ref_cfg, tree = family_model(arch)
    b16 = bf16_tree(tree)
    params = model_params_from_reference(b16, device="cpu")
    ref_params = jax.tree_util.tree_map(jnp.asarray, b16)
    aux = ref_aux = None
    if cfg.family in ("vlm", "encdec"):
        x = batch_for(cfg, 3, 4, seed=1)["aux"]
        ref_aux = ref_memory_from_aux(ref_params, ref_cfg,
                                      jnp.asarray(x).astype(jnp.bfloat16))
        assert ref_aux.dtype == jnp.bfloat16
        aux = bf16_from_reference(np.asarray(ref_aux), device="cpu")
    prompts = ([1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11])
    eng = ServeEngine(cfg, params, max_batch=3, cache_len=32, aux=aux,
                      device="cpu")
    assert {t.dtype for t in tree_paths(eng.cache).values()} == {
        torch.float32}
    got, log = _serve(eng, prompts, 5, _port_log)
    ref_eng = RefEngine(ref_cfg, ref_params, max_batch=3, cache_len=32,
                        aux=ref_aux)
    want, ref_log = _serve(ref_eng, prompts, 5, _ref_log)
    assert len(got) == len(prompts) and got.keys() == want.keys()
    assert len(log) == len(ref_log) == eng.stats()["host_syncs"]
    flip = _first_flip(log, ref_log)
    if equal:
        assert flip is None and got == want
    else:
        assert flip is not None and flip[1], flip
    upto = len(log) if flip is None else flip[0] + 1
    errs = [normwise(g, w) for g, w in zip(log[:upto], ref_log[:upto])]
    assert max(errs) <= BF16_TOL, errs


# -- the checkpoint of a bf16 state ----------------------------------------


def test_bf16_train_state_checkpoint_round_trips(tmp_path):
    """A bf16 train state after one step (8-bit moments) saved and restored
    bit for bit, plainly and with ``shardings=`` on the host mesh, every
    leaf in its own dtype; the manifest says "bfloat16"."""
    import json

    kw = dict(total_steps=10, accum_steps=1, peak_lr=1e-3, warmup_steps=2)
    cfg, _, state, _, tc, _ = _bf16_state("qwen2-0.5b", kw)
    batch = synth_batch(DataConfig(cfg.vocab, 16, 2, 0), 0)
    state, _ = build_train_step(cfg, tc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    path = save_checkpoint(str(tmp_path / "state"), 1, state)
    with open(f"{path}/manifest.json") as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    assert {v for k, v in dtypes.items() if k.startswith("params/")} == {
        "bfloat16"}
    template = tree_map(torch.zeros_like, state)
    plain, step, _ = restore_checkpoint(path, template)
    mesh = make_host_mesh("cpu")
    psh = param_sharding(model_specs(cfg, sharding_rules(mesh)), mesh)
    sharded, _, _ = restore_checkpoint(
        save_checkpoint(str(tmp_path / "params"), 1, state["params"]),
        template["params"], shardings=psh)
    want = tree_paths(state)
    assert step == 1
    for got in (tree_paths(plain), {f"params/{k}": v for k, v in
                                    tree_paths(sharded).items()}):
        for k, t in got.items():
            assert t.dtype == want[k].dtype, k
            raw = (lambda x: x.view(torch.int16)) \
                if t.dtype == torch.bfloat16 else (lambda x: x)
            assert torch.equal(raw(t), raw(want[k])), k
