"""The port's cross-attention (``layers.attention`` with ``kv_src``,
``layers.cross_attention_cached``), the cross sub-layer kinds
(``attn_ffn_cross``, ``enc_attn_ffn``, ``dec_attn_cross_ffn``) and the
``vlm`` and ``encdec`` families' whole models against the JAX package's,
on the CPU: ``llama-3.2-vision-90b`` and ``seamless-m4t-large-v2`` at smoke
size.

Single layers take weights drawn here with numpy at std 1/sqrt(d_in) (norm
scales, biases and the VLM's ``xgate`` away from their 1 / 0 inits, so each
takes part), the same arrays on both sides, and agree to LAYER_TOL = 1e-6
normwise (measured at most 4.7e-7, at 1601 keys in one chunk; 1.7e-7 to
2.9e-7 elsewhere).  Whole models are drawn by the reference's
``init_model`` with every ``xgate`` set non-zero (its init is 0, which
would leave the VLM's cross path out) and carried across by
``convert.model_params_from_reference``.

Tolerances (C9).  The reference's ``fan_in`` rule draws a stacked leaf with
std 1/sqrt(n_rep), 1/sqrt(2) here, so the softmax of every attention is
nearly one-hot and a last-place difference in a score moves the output far
more than the arithmetic does.  On the weights as drawn the two packages'
final hidden states differ by more than 1e-5 on some draws, most of all
for encdec, whose memory runs through two non-causal encoder layers and
then into two cross-attentions; the loss, which averages over the logits,
stays within 1e-5.  So hidden states and logits are held at MODEL_TOL =
1e-5 normwise on the same weights rescaled to std 1/sqrt(d_in)
(``well_scaled``, as ``chip_smoke.py`` does at full width; measured at
most 1.1e-6), and the loss at 1e-5 relative on both.
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
from repro.models import init_model as ref_init_model
from repro.models import prefill as ref_prefill
from repro.models import train_loss as ref_train_loss
from repro.models.blocks import _sub_decode as ref_sub_decode
from repro.models.blocks import _sub_forward as ref_sub_forward
from repro.models.layers import _chunked_attn as ref_chunked_attn
from repro.models.layers import attention as ref_attention
from repro.models.layers import cross_attention_cached as ref_cross_cached
from repro.models.lm import _memory_from_aux as ref_memory_from_aux
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models import decode_step, init_cache, model_tables, \
    prefill, smoke, train_loss
from repro_torch.models.blocks import _sub_decode, _sub_forward, \
    _sub_table, sub_cache_shape
from repro_torch.models.layers import _chunked_attn, attention, \
    attention_table, cross_attention_cached, lm_logits
from repro_torch.models.lm import _memory_from_aux
from repro_torch.models.params import Leaf
from repro_torch.serving import ServeEngine

LAYER_TOL = 1e-6
MODEL_TOL = 1e-5
DECODE_TOL = 5e-5
CROSS = ("llama-3.2-vision-90b", "seamless-m4t-large-v2")
XGATE = 0.7


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(arch, **kw):
    cfg, ref_cfg = smoke(get_config(arch)), ref_config.smoke(REF_ARCHS[arch])
    return dataclasses.replace(cfg, **kw), dataclasses.replace(ref_cfg, **kw)


def draw(table, rng):
    """numpy arrays for ``table``: ``fan_in`` leaves at std 1/sqrt(d_in),
    the others near their inits but not on them."""
    if isinstance(table, Leaf):
        x = rng.normal(size=table.shape)
        if table.init == "fan_in":
            x = x / np.sqrt(table.shape[-2])
        elif table.init == "ones":
            x = 1.0 + 0.1 * x
        else:
            x = 0.5 * x
        return np.asarray(x, np.float32)
    return {k: draw(v, rng) for k, v in table.items()}


def both(tree):
    """(port tensors, reference arrays) of a tree of numpy arrays."""
    return (jax.tree_util.tree_map(torch.from_numpy, tree),
            jax.tree_util.tree_map(jnp.asarray, tree))


def well_scaled(cfg, tree):
    """``tree`` (numpy) with every stacked ``fan_in`` leaf rescaled from the
    reference's std 1/sqrt(n_rep) to 1/sqrt(d_in)."""

    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return (p * (t.shape[0] / t.shape[-2]) ** 0.5).astype(
                    np.float32)
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), tree)


def model(arch, seed=0, scaled=True):
    """(port cfg, reference cfg, port params, reference params, numpy
    params) at smoke size, the reference's draw, every ``xgate`` at
    XGATE, rescaled by :func:`well_scaled` unless ``scaled`` is False."""
    cfg, ref_cfg = configs(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_cfg, jax.random.PRNGKey(seed)))
    for sub in tree["blocks"].values():
        if "xgate" in sub:
            sub["xgate"] = np.full_like(sub["xgate"], XGATE)
    if scaled:
        tree = well_scaled(cfg, tree)
    return (cfg, ref_cfg, model_params_from_reference(tree, device="cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree), tree)


def memory_len(cfg) -> int:
    return cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames


def aux_for(cfg, b, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, memory_len(cfg), cfg.d_model)).astype(np.float32)


def tokens(cfg, b, s, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("kv_len,causal,use_rope", [
    (25, False, False),     # cross-attention: 25 keys, chunk 8 (one chunk)
    (40, False, False),     # 40 keys in 5 chunks of 8
    (None, False, True),    # the encoder's self-attention
    (None, True, True)])    # the decoder's
def test_attention_matches_the_reference(kv_len, causal, use_rope):
    cfg, ref_cfg = configs(CROSS[0], attn_q_chunk=8, attn_kv_chunk=8)
    rng = np.random.default_rng(kv_len or 3)
    p, rp = both(draw(attention_table(cfg, bias=True), rng))
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    mem = None if kv_len is None else rng.normal(
        size=(2, kv_len, cfg.d_model)).astype(np.float32)
    got = attention(p, cfg, torch.from_numpy(x), causal=causal,
                    use_rope=use_rope,
                    kv_src=None if mem is None else torch.from_numpy(mem))
    want = ref_attention(rp, ref_cfg, jnp.asarray(x), causal=causal,
                         use_rope=use_rope,
                         kv_src=None if mem is None else jnp.asarray(mem))
    assert got.shape == (2, 16, cfg.d_model)
    assert normwise(got.numpy(), want) <= LAYER_TOL


def test_attention_table_bias_follows_the_argument():
    cfg = dataclasses.replace(smoke(get_config(CROSS[0])), qkv_bias=True)
    assert set(attention_table(cfg)["wk"]) == {"w", "b"}
    assert set(attention_table(cfg, bias=False)["wk"]) == {"w"}
    assert set(attention_table(dataclasses.replace(cfg, qkv_bias=False),
                               bias=True)["wq"]) == {"w", "b"}
    assert set(attention_table(cfg)["wo"]) == {"w"}


@pytest.mark.parametrize("sq,skv,cq,ck", [(16, 25, 8, 8), (12, 1601, 64, 64),
                                          (7, 24, 4, 8)])
def test_chunked_attention_off_the_chunk_matches_the_reference(sq, skv, cq,
                                                               ck):
    """Non-causal, a key length other than the query length that the kv
    chunk does not divide (the single-chunk branch; 1601 is the VLM's image
    tokens), and a query length the q chunk does not divide."""
    b, hkv, g, dh = 2, 2, 2, 16
    rng = np.random.default_rng(sq * skv)
    q = rng.normal(size=(b, sq, hkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    got = _chunked_attn(*(torch.from_numpy(t) for t in (q, k, v)),
                        causal=False, q_offset=0, q_chunk=cq,
                        kv_chunk=ck).numpy()
    want = ref_chunked_attn(*(jnp.asarray(t) for t in (q, k, v)),
                            causal=False, q_offset=0, q_chunk=cq,
                            kv_chunk=ck)
    assert got.shape == (b, sq, hkv, g, dh)
    assert normwise(got, want) <= LAYER_TOL


@pytest.mark.parametrize("n", [24, 25])
def test_cross_attention_cached_matches_the_reference(n):
    cfg, ref_cfg = configs(CROSS[0])
    rng = np.random.default_rng(n)
    p, rp = both(draw(attention_table(cfg, bias=False), rng))
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    mk, mv = (rng.normal(size=(3, n, cfg.n_kv_heads, cfg.d_head))
              .astype(np.float32) for _ in range(2))
    got = cross_attention_cached(p, cfg, torch.from_numpy(x),
                                 torch.from_numpy(mk), torch.from_numpy(mv))
    want = ref_cross_cached(rp, ref_cfg, jnp.asarray(x), jnp.asarray(mk),
                            jnp.asarray(mv))
    assert got.shape == (3, 1, cfg.d_model)
    assert normwise(got.numpy(), want) <= LAYER_TOL
    # the memory in bf16 (a bf16 cache) is widened before its products
    got16 = cross_attention_cached(
        p, cfg, torch.from_numpy(x), torch.from_numpy(mk).bfloat16(),
        torch.from_numpy(mv).bfloat16())
    want16 = ref_cross_cached(rp, ref_cfg, jnp.asarray(x),
                              jnp.asarray(mk, jnp.bfloat16),
                              jnp.asarray(mv, jnp.bfloat16))
    assert got16.dtype == torch.float32
    assert normwise(got16.numpy(), want16) <= LAYER_TOL


# -- sub-layers ----------------------------------------------------------------


@pytest.mark.parametrize("kind,arch", [
    ("attn_ffn_cross", CROSS[0]), ("enc_attn_ffn", CROSS[1]),
    ("dec_attn_cross_ffn", CROSS[1])])
@pytest.mark.parametrize("causal", [True, False])
def test_cross_sub_forward_matches_the_reference(kind, arch, causal):
    """One sub-layer over a full sequence, the memory's 24 or 32 positions
    for the cross kinds; the encoder's kind is non-causal either way."""
    cfg, ref_cfg = configs(arch)
    rng = np.random.default_rng(len(kind))
    p, rp = both(draw(_sub_table(cfg, kind), rng))
    h = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    mem = aux_for(cfg, 2)
    got, aux = _sub_forward(p, None, cfg, kind, torch.from_numpy(h),
                            memory=torch.from_numpy(mem), causal=causal)
    want, _ = ref_sub_forward(rp, None, ref_cfg, kind, jnp.asarray(h),
                              memory=jnp.asarray(mem), causal=causal)
    assert float(aux) == 0.0
    assert normwise(got.numpy(), want) <= LAYER_TOL
    if kind == "attn_ffn_cross":   # the gate at 0 leaves the cross path out
        p0 = dict(p, xgate=torch.zeros(()))
        no_x, _ = _sub_forward(p0, None, cfg, kind, torch.from_numpy(h),
                               memory=torch.from_numpy(mem), causal=causal)
        plain, _ = _sub_forward({k: v for k, v in p.items()
                                 if k not in ("xgate", "lnx", "xattn")},
                                None, cfg, "attn_ffn", torch.from_numpy(h),
                                causal=causal)
        assert torch.equal(no_x, plain)
        assert normwise(got.numpy(), no_x.numpy()) > 1e-3


@pytest.mark.parametrize("kind,arch", [
    ("attn_ffn_cross", CROSS[0]), ("dec_attn_cross_ffn", CROSS[1])])
def test_cross_sub_decode_matches_the_reference(kind, arch):
    """One decode sub-layer from an f32 cache with slots at different
    positions and the memory's K/V in ``xk``/``xv``: its output and every
    cache leaf (``xk``/``xv`` passed through unchanged)."""
    cfg, ref_cfg = configs(arch)
    rng = np.random.default_rng(7)
    p, rp = both(draw(_sub_table(cfg, kind), rng))
    cache = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
             for k, v in sub_cache_shape(cfg, kind, 3, 8,
                                         device="cpu").items()}
    c, rc = both(cache)
    h = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([0, 3, 7], np.int32)
    got, gc = _sub_decode(p, None, cfg, kind, torch.from_numpy(h), c,
                          torch.from_numpy(cur))
    want, wc = ref_sub_decode(rp, None, ref_cfg, kind, jnp.asarray(h), rc,
                              jnp.asarray(cur))
    assert normwise(got.numpy(), want) <= LAYER_TOL
    assert set(gc) == set(wc) == {"k", "v", "xk", "xv"}
    for name in gc:
        assert normwise(gc[name].numpy(), wc[name]) <= LAYER_TOL, name
    assert gc["xk"] is c["xk"] and gc["xv"] is c["xv"]


# -- whole models ----------------------------------------------------------------


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_and_loss_match_the_reference(arch):
    """``test_arch_smoke``'s batch (B = 2, S = 64, normal ``aux``) through
    ``prefill`` (hidden state, on well-scaled weights) and ``train_loss``
    (on the weights as drawn and well-scaled); the encoder's memory on its
    own."""
    tok = tokens(configs(arch)[0], 2, 64)
    for scaled in (False, True):
        cfg, ref_cfg, params, ref_params, _ = model(arch, scaled=scaled)
        aux = aux_for(cfg, 2)
        batch = {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(np.roll(tok, -1, 1)).long(),
                 "aux": torch.from_numpy(aux)}
        got = float(train_loss(params, cfg, batch))
        want = float(ref_train_loss(ref_params, ref_cfg, {
            "tokens": jnp.asarray(tok), "labels": jnp.asarray(
                np.roll(tok, -1, 1)), "aux": jnp.asarray(aux)}))
        assert np.isfinite(got) and got > 0
        assert abs(got - want) <= MODEL_TOL * abs(want), scaled
    h = prefill(params, cfg, batch["tokens"], batch["aux"])
    want = ref_prefill(ref_params, ref_cfg, jnp.asarray(tok),
                       jnp.asarray(aux))
    assert h.shape == want.shape and h.dtype == torch.float32
    assert normwise(h.numpy(), want) <= MODEL_TOL
    mem = _memory_from_aux(params, cfg, batch["aux"])
    ref_mem = ref_memory_from_aux(ref_params, ref_cfg, jnp.asarray(aux))
    if cfg.family == "vlm":
        assert mem is batch["aux"]
    else:
        assert normwise(mem.numpy(), ref_mem) <= MODEL_TOL
    # the memory moves the output
    other = prefill(params, cfg, batch["tokens"], batch["aux"] * 2 + 1)
    assert normwise(other.numpy(), h.numpy()) > 1e-3


def _memory_cache(cfg, tree, mem, b, s, dtype=np.float32):
    """An f32 cache (numpy) with every cross sub-layer's ``xk``/``xv`` the
    memory's projections, rep by rep, as the serving engine installs
    them."""
    cache = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, dtype),
        init_cache(cfg, b, s, dtype=torch.float32, device="cpu"))
    for key, sub in tree["blocks"].items():
        if "xattn" not in sub:
            continue
        shape = (b, mem.shape[1], cfg.n_kv_heads, cfg.d_head)
        for name, w in (("xk", "wk"), ("xv", "wv")):
            cache[key][name] = np.stack(
                [(mem @ sub["xattn"][w]["w"][r]).reshape(shape)
                 for r in range(sub["xattn"][w]["w"].shape[0])]).astype(
                    dtype)
    return cache


@pytest.mark.parametrize("arch", CROSS)
def test_decode_matches_the_reference(arch):
    """Four decode steps from an f32 cache holding the memory's K/V (the
    encoder's output for encdec): logits and every cache leaf."""
    cfg, ref_cfg, params, ref_params, tree = model(arch)
    tok = tokens(cfg, 2, 4, seed=2)
    mem = np.asarray(ref_memory_from_aux(ref_params, ref_cfg,
                                         jnp.asarray(aux_for(cfg, 2))))
    ref_cache = jax.tree_util.tree_map(
        jnp.asarray, _memory_cache(cfg, tree, mem, 2, 16))
    cache = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), ref_cache)
    step = jax.jit(lambda p, t, c, i: ref_decode_step(p, ref_cfg, t, c, i))
    for t in range(4):
        got, cache = decode_step(params, cfg,
                                 torch.from_numpy(tok[:, t:t + 1]).long(),
                                 cache, t)
        want, ref_cache = step(ref_params, jnp.asarray(tok[:, t:t + 1]),
                               ref_cache, jnp.int32(t))
        assert got.shape == (2, 1, cfg.vocab_padded)
        assert normwise(got[..., :cfg.vocab].numpy(),
                        np.asarray(want)[..., :cfg.vocab]) <= MODEL_TOL, t
        for g, w in zip(jax.tree_util.tree_leaves(cache),
                        jax.tree_util.tree_leaves(ref_cache)):
            if np.any(np.asarray(w)):
                assert normwise(g.numpy(), w) <= MODEL_TOL, t


@pytest.mark.parametrize("arch", CROSS)
def test_decode_step_equals_the_last_position_of_prefill(arch):
    """Teacher-forced decode with slots at different positions (per-slot
    ``cur_len``), the memory installed by the serving engine from
    ``_memory_from_aux``: each step's logits equal prefill's at that slot's
    position within DECODE_TOL normwise (as for the other families: the
    one-token attention and the chunked one round differently)."""
    cfg, _, params, _, _ = model(arch)
    s = 16
    tok = torch.from_numpy(tokens(cfg, 2, s, seed=3)).long()
    aux = torch.from_numpy(aux_for(cfg, 2))
    full = lm_logits(params["unembed"], cfg,
                     prefill(params, cfg, tok, aux))[..., :cfg.vocab]
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=s,
                      aux=_memory_from_aux(params, cfg, aux), device="cpu")
    cache = eng.cache
    start = torch.tensor([0, 3])
    for t in range(s + 3):
        cur = (t - start).clamp(min=0, max=s - 1)
        step = tok[torch.arange(2), cur][:, None]
        logits, new_cache = decode_step(params, cfg, step, cache,
                                        cur.to(torch.int32))
        live = (t >= start) & (t - start < s)
        cache = jax.tree_util.tree_map(
            lambda n, o: torch.where(
                live.reshape((1, 2) + (1,) * (n.dim() - 2)), n, o),
            new_cache, cache)
        for b in range(2):
            if live[b]:
                assert normwise(logits[b, 0, :cfg.vocab].numpy(),
                                full[b, int(cur[b])].numpy()) <= DECODE_TOL
