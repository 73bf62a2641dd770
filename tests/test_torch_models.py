"""The port's model stack (``repro_torch.models``: config, params, layers,
blocks, lm) against the JAX package's: every config's tables, caches and
inits, and the dense family's layers and whole models (the MoE, SSM and
hybrid families' whole models are in
``tests/test_torch_models_families.py``, the cross-attention families' in
``tests/test_torch_models_cross.py``).

Inputs are made with numpy from a seed; whole models are drawn by the
reference's ``init_model`` and carried across by
``convert.model_params_from_reference``, so both packages run the same
weights.  The port runs on the CPU.

Tolerances.  A single layer agrees to about 2e-7 relative (torch's and
XLA's CPU matmuls, ``pow`` and ``rsqrt`` round alike to a few ulps).  The
reference's ``fan_in`` rule draws a stacked ``[n_rep, d_in, d_out]`` leaf
with std 1/sqrt(n_rep), so at smoke widths the attention scores run to the
hundreds and the softmax is nearly one-hot: a last-place difference in a
score moves a weight by far more than that, and the differences grow with
depth.  Whole-model outputs are therefore held normwise (the norm of the
difference over the norm of the reference) at MODEL_TOL = 1e-5, and the
loss relatively at the same tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.models import model_tables as ref_model_tables
from repro.models import prefill as ref_prefill
from repro.models import train_loss as ref_train_loss
from repro.models.blocks import block_structure as ref_block_structure
from repro.models.layers import _chunked_attn as ref_chunked_attn
from repro.models.layers import lm_logits as ref_lm_logits
from repro.models.layers import lm_loss as ref_lm_loss
from repro.models.layers import rms_norm as ref_rms_norm
from repro.models.layers import rope as ref_rope
from repro.models.params import Leaf as RefLeaf
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models import (
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K, Leaf,
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, backbone, decode_step,
    init_cache, init_model, model_tables, prefill, shapes_for, smoke,
    train_loss,
)
from repro_torch.models import config as port_config
from repro_torch.models.blocks import block_structure, stage_cache, \
    sub_cache_shape, superblock_table
from repro_torch.models.layers import NEG_INF, _chunked_attn, lm_logits, \
    lm_loss, rms_norm, rope
from repro_torch.models.params import stack_tables

ATTN_TOL = 2e-5
LAYER_TOL = 1e-5
MODEL_TOL = 1e-5
DENSE = ("granite-20b", "qwen2-0.5b", "yi-34b", "deepseek-coder-33b")
CROSS = ("llama-3.2-vision-90b", "seamless-m4t-large-v2")
FAMILIES = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
            "falcon-mamba-7b", "zamba2-2.7b") + CROSS
PORTED = DENSE + FAMILIES


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def port_config_of(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with a reference config's fields."""
    kw = dataclasses.asdict(ref_cfg)
    kw["moe"] = MoEConfig(**kw["moe"]) if kw["moe"] else None
    kw["ssm"] = SSMConfig(**kw["ssm"]) if kw["ssm"] else None
    return ModelConfig(**kw)


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    """(port cfg, reference cfg, port params, reference params) at smoke
    size, the weights drawn by the reference from a fixed key."""
    ref_cfg = ref_config.smoke(REF_ARCHS[request.param])
    ref_params = ref_init_model(ref_cfg, jax.random.PRNGKey(0))
    params = model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return smoke(get_config(request.param)), ref_cfg, params, ref_params


def tokens(cfg, b=2, s=16, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# -- configs, shapes, tables ---------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_are_the_references(arch):
    assert dataclasses.asdict(get_config(arch)) \
        == dataclasses.asdict(REF_ARCHS[arch])
    assert dataclasses.asdict(smoke(get_config(arch))) \
        == dataclasses.asdict(ref_config.smoke(REF_ARCHS[arch]))
    assert sorted(ARCHS) == sorted(PORTED)


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_ssm_hybrid_configs_are_the_references(arch):
    """The MoE, SSM, hybrid, VLM and encoder-decoder configs, full and at
    smoke size, with their MoE and SSM sub-configs and derived widths."""
    cfg, ref = get_config(arch), REF_ARCHS[arch]
    for got, want in ((cfg, ref), (smoke(cfg), ref_config.smoke(ref))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.d_inner, got.dt_rank_actual, got.vocab_padded) \
            == (want.d_inner, want.dt_rank_actual, want.vocab_padded)


def test_shape_configs_are_the_references():
    for got, want in zip(ALL_SHAPES, ref_config.ALL_SHAPES):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [s.name for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)] \
        == [s.name for s in ref_config.ALL_SHAPES]
    assert port_config.ShapeConfig is ShapeConfig
    for name in sorted(REF_ARCHS):
        cfg = port_config_of(REF_ARCHS[name])
        assert [s.name for s in shapes_for(cfg)] == [
            s.name for s in ref_config.shapes_for(REF_ARCHS[name])], name


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_block_structure_is_the_references(arch):
    """Every family's super-block, the non-dense ones included."""
    for cfg in (REF_ARCHS[arch], ref_config.smoke(REF_ARCHS[arch])):
        assert block_structure(port_config_of(cfg)) \
            == ref_block_structure(cfg)


def _leaf_shapes(table, leaf_type):
    if isinstance(table, leaf_type):
        return (table.shape, table.axes, table.init)
    return {k: _leaf_shapes(v, leaf_type) for k, v in table.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_model_tables_are_the_references(arch):
    cfg = get_config(arch)
    assert _leaf_shapes(model_tables(cfg), Leaf) \
        == _leaf_shapes(ref_model_tables(REF_ARCHS[arch]), RefLeaf)
    table, kinds, n_rep, shared = superblock_table(cfg)
    assert kinds == ["attn_ffn"] and n_rep == cfg.n_layers \
        and shared is None
    stacked = stack_tables(table, 3)
    assert stacked["l0"]["attn"]["wq"]["w"].shape \
        == (3,) + table["l0"]["attn"]["wq"]["w"].shape
    assert stacked["l0"]["ln1"]["scale"].axes == ("layers", "embed")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_tables_are_the_references(arch):
    """The MoE layers' expert stacks, the Mamba tables, the hybrid
    family's shared table (``t["shared"]``), the cross layers' ``xattn``
    (no bias), ``lnx`` and ``xgate`` and the encoder's table and
    ``enc_norm``, full and at smoke size."""
    for cfg, ref in ((get_config(arch), REF_ARCHS[arch]),
                     (smoke(get_config(arch)),
                      ref_config.smoke(REF_ARCHS[arch]))):
        assert _leaf_shapes(model_tables(cfg), Leaf) \
            == _leaf_shapes(ref_model_tables(ref), RefLeaf)
        table, kinds, n_rep, shared = superblock_table(cfg)
        assert (kinds, n_rep, shared is not None) == block_structure(cfg)
    assert ("shared" in model_tables(cfg)) == (cfg.family == "hybrid")


@pytest.mark.parametrize("arch", CROSS)
def test_cross_kinds_tables_and_caches(arch):
    """The cross kinds' sub-tables (``xgate`` only on the VLM's, a zero
    scalar per rep), the memory's K/V in the cache at the config's image
    tokens or audio frames, the encoder table of encdec; an unknown kind
    raises."""
    cfg = smoke(get_config(arch))
    kinds, n_rep, _ = block_structure(cfg)
    cross = kinds[-1]
    assert cross == ("attn_ffn_cross" if cfg.family == "vlm"
                     else "dec_attn_cross_ffn")
    t = model_tables(cfg)
    sub = t["blocks"][f"l{len(kinds) - 1}"]
    assert set(sub) == {"ln1", "attn", "lnx", "xattn", "ln2", "ffn"} | (
        {"xgate"} if cfg.family == "vlm" else set())
    assert set(sub["xattn"]["wq"]) == {"w"}
    if cfg.family == "vlm":
        assert (sub["xgate"].shape, sub["xgate"].init) == ((n_rep,), "zeros")
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    c = sub_cache_shape(cfg, cross, 3, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        "k": (3, 8, cfg.n_kv_heads, cfg.d_head),
        "v": (3, 8, cfg.n_kv_heads, cfg.d_head),
        "xk": (3, n, cfg.n_kv_heads, cfg.d_head),
        "xv": (3, n, cfg.n_kv_heads, cfg.d_head)}
    assert ("encoder" in t) == ("enc_norm" in t) == (cfg.family == "encdec")
    if cfg.family == "encdec":
        assert t["encoder"]["l0"]["attn"]["wq"]["w"].shape[0] \
            == cfg.n_encoder_layers
    with pytest.raises(ValueError):
        sub_cache_shape(cfg, "enc_attn_ffn", 1, 4, device="cpu")
    with pytest.raises(ValueError):
        superblock_table(dataclasses.replace(cfg, family="other"))


def test_init_model_draws_from_the_generator():
    cfg = smoke(get_config("granite-20b"))
    p = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    q = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    ref = ref_init_model(ref_config.smoke(REF_ARCHS["granite-20b"]),
                         jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref)
    got = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), p)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)))
    # fan_in on a stacked leaf: the first axis, the reps' (std 1/sqrt(4))
    w = p["blocks"]["l0"]["ffn"]["gate"]["w"]
    assert abs(float(w.std()) - 0.5) < 0.02
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))


def _dtypes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_cache_and_init_model_are_the_references(arch):
    """K/V caches, a mamba layer's (conv window, SSM state), bf16 by
    default and f32 when asked (the state f32 in both); the params' tree,
    shapes and dtypes drawn from the generator, the same twice."""
    cfg = smoke(get_config(arch))
    ref_cfg = ref_config.smoke(REF_ARCHS[arch])
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        got = init_cache(cfg, 3, 16, device="cpu",
                         **({"dtype": dtype} if dtype else {}))
        want = ref_init_cache(ref_cfg, 3, 16,
                              **({"dtype": jdtype} if jdtype else {}))
        assert _dtypes(got) == jax.tree_util.tree_map(
            lambda a: (a.shape, str(a.dtype)), want)
        assert not any(bool(a.any()) for a in jax.tree_util.tree_leaves(got))
    p = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    q = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    ref = jax.eval_shape(lambda: ref_init_model(ref_cfg,
                                                jax.random.PRNGKey(0)))
    assert _dtypes(p) == jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), ref)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(q)))


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "zamba2-2.7b"] + list(CROSS))
def test_model_params_from_reference_carries_every_subtree(arch):
    """The shared table, the ``[n_rep, E, d, f]`` expert stacks, the cross
    layers' ``xattn`` and ``[n_rep]`` ``xgate`` and the encoder's stack and
    ``enc_norm`` come across leaf for leaf, values and shapes."""
    ref_cfg = ref_config.smoke(REF_ARCHS[arch])
    ref = jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_cfg, jax.random.PRNGKey(3)))
    got = model_params_from_reference(ref, device="cpu")
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(ref)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    if arch == "zamba2-2.7b":
        assert set(got["shared"]) == {"ln1", "attn", "ln2", "ffn"}
        assert got["blocks"]["l2"] == {}
    elif arch == "llama-3.2-vision-90b":
        assert tuple(got["blocks"]["l1"]["xgate"].shape) \
            == (ref_cfg.n_layers // 2,)
        assert set(got["blocks"]["l1"]["xattn"]) == {"wq", "wk", "wv", "wo"}
    elif arch == "seamless-m4t-large-v2":
        assert tuple(got["encoder"]["l0"]["ffn"]["up"]["w"].shape) == (
            ref_cfg.n_encoder_layers, ref_cfg.d_model, ref_cfg.d_ff)
        assert tuple(got["enc_norm"]["scale"].shape) == (ref_cfg.d_model,)
        assert "xattn" in got["blocks"]["l0"]
    else:
        n_rep, e = ref_cfg.n_layers // 2, ref_cfg.moe.n_experts
        assert tuple(got["blocks"]["l1"]["moe"]["gate"].shape) == (
            n_rep, e, ref_cfg.d_model, ref_cfg.moe.d_ff_expert)
        assert "shared" in got["blocks"]["l1"]["moe"]


def test_init_cache_is_the_references():
    cfg = smoke(get_config("qwen2-0.5b"))
    ref = ref_init_cache(ref_config.smoke(REF_ARCHS["qwen2-0.5b"]), 3, 16)
    got = init_cache(cfg, 3, 16, device="cpu")
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref) \
        == jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            got)
    f32 = init_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    assert f32["l0"]["k"].dtype == torch.float32 \
        and not f32["l0"]["k"].any()
    assert stage_cache(cfg, ["attn_ffn"], 2, 1, 4, device="cpu")["l0"][
        "v"].shape == (2, 1, 4, cfg.n_kv_heads, cfg.d_head)


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    cfg = smoke(get_config("granite-20b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_params_from_reference({"w": np.zeros(2)})


# -- layers --------------------------------------------------------------------


def _naive_attn(q, k, v, causal):
    """Softmax attention in f64 numpy, the whole score matrix at once."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    dh = q.shape[-1]
    s = np.einsum("bqhgd,bkhd->bhgqk", q * dh ** -0.5, k)
    if causal:
        mask = np.tril(np.ones((q.shape[1], k.shape[1]), bool))
        s = np.where(mask, s, NEG_INF)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhgqk,bkhd->bqhgd", w, v)


@pytest.mark.parametrize("causal,sq,skv,cq,ck", [
    (True, 64, 64, 16, 16), (False, 64, 64, 16, 16),
    (True, 32, 32, 32, 8), (False, 32, 32, 32, 8),
    (False, 64, 128, 16, 64)])
def test_chunked_attention_matches_naive(causal, sq, skv, cq, ck):
    """The reference's three chunkings (causal only where square)."""
    b, hkv, g, dh = 2, 2, 3, 16
    rng = np.random.default_rng(sq + skv + cq + ck)
    q = rng.normal(size=(b, sq, hkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    got = _chunked_attn(*(torch.from_numpy(t) for t in (q, k, v)),
                        causal=causal, q_offset=0, q_chunk=cq,
                        kv_chunk=ck).numpy()
    np.testing.assert_allclose(got, _naive_attn(q, k, v, causal),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    want = np.asarray(ref_chunked_attn(
        *(jnp.asarray(t) for t in (q, k, v)), causal=causal, q_offset=0,
        q_chunk=cq, kv_chunk=ck))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_rms_norm_and_rope_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3
    scale = rng.normal(size=32).astype(np.float32)
    got = rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = ref_rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    pos = rng.integers(0, 200, size=(2, 5))
    for theta in (1e4, 1e6):
        got = rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = ref_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)


def test_lm_logits_and_loss_match_the_reference():
    """The padded vocabulary masked to NEG_INF, the loss chunked over the
    sequence, masked labels (-1) ignored."""
    cfg = dataclasses.replace(smoke(get_config("granite-20b")), vocab=500)
    ref_cfg = dataclasses.replace(
        ref_config.smoke(REF_ARCHS["granite-20b"]), vocab=500)
    assert cfg.vocab_padded == 512
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    w = (rng.normal(size=(cfg.d_model, 512)) * 0.02).astype(np.float32)
    labels = rng.integers(0, 500, size=(2, 128)).astype(np.int32)
    labels[:, 40:70] = -1
    pu, rpu = {"w": torch.from_numpy(w)}, {"w": jnp.asarray(w)}
    got = lm_logits(pu, cfg, torch.from_numpy(h))
    want = ref_lm_logits(rpu, ref_cfg, jnp.asarray(h))
    assert bool((got[..., 500:] == NEG_INF).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    for lab in (labels, np.maximum(labels, 0)):
        got = float(lm_loss(pu, cfg, torch.from_numpy(h),
                            torch.from_numpy(lab)))
        want = float(ref_lm_loss(rpu, ref_cfg, jnp.asarray(h),
                                 jnp.asarray(lab)))
        assert abs(got - want) <= LAYER_TOL * abs(want)
    with pytest.raises(ValueError, match="multiple"):
        lm_loss(pu, cfg, torch.from_numpy(h[:, :100]),
                torch.from_numpy(labels[:, :100]))


# -- the whole model -------------------------------------------------------------


def test_prefill_decode_and_loss_match_the_reference(model):
    cfg, ref_cfg, params, ref_params = model
    tok = tokens(cfg)
    got = prefill(params, cfg, torch.from_numpy(tok).long())
    want = ref_prefill(ref_params, ref_cfg, jnp.asarray(tok))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert normwise(got.numpy(), want) <= MODEL_TOL

    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(np.roll(tok, -1, 1)).long()}
    got = float(train_loss(params, cfg, batch))
    want = float(ref_train_loss(ref_params, ref_cfg, {
        "tokens": jnp.asarray(tok), "labels": jnp.asarray(np.roll(tok, -1,
                                                                  1))}))
    assert abs(got - want) <= MODEL_TOL * abs(want)

    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    ref_cache = ref_init_cache(ref_cfg, 2, 16, jnp.float32)
    for t in range(4):
        got, cache = decode_step(params, cfg,
                                 torch.from_numpy(tok[:, t:t + 1]).long(),
                                 cache, t)
        want, ref_cache = ref_decode_step(ref_params, ref_cfg,
                                          jnp.asarray(tok[:, t:t + 1]),
                                          ref_cache, jnp.int32(t))
        assert got.shape == (2, 1, cfg.vocab_padded)
        assert normwise(got[..., :cfg.vocab].numpy(),
                        np.asarray(want)[..., :cfg.vocab]) <= MODEL_TOL, t
        for name in ("k", "v"):
            assert normwise(cache["l0"][name].numpy(),
                            np.asarray(ref_cache["l0"][name])) <= MODEL_TOL


@pytest.mark.parametrize("arch", ["granite-20b", "qwen2-0.5b"])
def test_decode_step_equals_the_last_position_of_prefill(arch):
    """Teacher-forced decode, slots at different positions: slot 1 starts
    two tokens later (per-slot ``cur_len``), and each step's logits equal
    the full forward's at that slot's position."""
    cfg = smoke(get_config(arch))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(tokens(cfg, b=2, s=10, seed=3)).long()
    h, aux = backbone(params, cfg, tok)
    assert float(aux) == 0.0
    full = lm_logits(params["unembed"], cfg, h)[..., :cfg.vocab]
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    start = torch.tensor([0, 2])
    for t in range(10):
        cur = (t - start).clamp(min=0)
        step = tok[torch.arange(2), cur][:, None]
        logits, cache = decode_step(params, cfg, step, cache,
                                    cur.to(torch.int32))
        for b in range(2):
            if t >= int(start[b]):
                assert normwise(logits[b, 0, :cfg.vocab].numpy(),
                                full[b, int(cur[b])].numpy()) <= MODEL_TOL


def test_tf32_setting_does_not_reach_the_cpu():
    """The TF32 refusal applies on the card only: the CPU has no TF32, and
    the setting is restored."""
    cfg = smoke(get_config("granite-20b"))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(tokens(cfg, b=1, s=4)).long()
    before = torch.get_float32_matmul_precision()
    want = prefill(params, cfg, tok)
    torch.set_float32_matmul_precision("high")
    try:
        got = prefill(params, cfg, tok)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)
