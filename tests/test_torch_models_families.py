"""The port's model stack on the MoE, SSM and hybrid families against the
JAX package's, on the CPU: ``qwen3-moe-30b-a3b``, ``llama4-maverick-400b-
a17b`` (alternating dense and MoE layers, a shared expert),
``falcon-mamba-7b`` (Mamba1) and ``zamba2-2.7b`` (Mamba2 with the tied
attention block) at smoke size, and the bf16 cache of every family (the
cross-attention families' whole models are in
``tests/test_torch_models_cross.py``).

Weights are drawn by the reference's ``init_model`` and carried across by
``convert.model_params_from_reference``; tokens are made with numpy from a
seed.  The reference's decode step runs under ``jax.jit`` (one compile a
config), as a server would run it.

Tolerances.  As for the dense family (``tests/test_torch_models.py``), the
reference's ``fan_in`` rule draws a stacked leaf with std 1/sqrt(n_rep), so
at smoke widths the attention softmax is nearly one-hot and a last-place
difference grows about twofold a layer.  Decode logits and the loss are
held at MODEL_TOL = 1e-5 (normwise, and relatively for the loss).  The
prefill's final hidden state, 32 positions through four layers of
attention, is held at PREFILL_TOL = 2e-5 normwise: qwen3-moe measures
1.04e-5 there, of which a layer's own share is 7.5e-7 from attention and
1e-7 from ``moe_ffn`` on the same input (the MoE layer adds nothing of its
own beyond the dense family's growth); the other three measure 2.9e-6 to
8.4e-6.

The bf16 cache (``init_cache``'s default in both packages).  Both packages
round the same f32 K/V and attention weights to bf16 (unit roundoff
u = 2^-8).  Where their f32 values, which agree to delta ~ 1e-6, straddle a
bf16 rounding boundary (a fraction of about delta/(2u) of the elements),
the two cached values differ by one bf16 step, 2u relative; elsewhere they
are equal.  So a cached tensor differs normwise by about 2u sqrt(delta /
(2u)) = sqrt(2 u delta) ~ 1e-4, and a step's logits, through a few layers,
by a small multiple of that: BF16_TOL = u = 2^-8 bounds it with room
(measured at most 7.4e-5, llama-3.2-vision, whose cache also holds the
memory's K/V in bf16; zamba2 6.5e-5).  The cache's dtypes must equal the
reference's after every step: a mamba layer's conv window comes back f32
from a bf16 one (its concatenation with the f32 step promotes it).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import backbone as ref_backbone
from repro.models import config as ref_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.models import train_loss as ref_train_loss
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.models import backbone, decode_step, decode_step_loop, \
    init_cache, init_model, prefill, smoke, train_loss
from repro_torch.models.layers import lm_logits

MODEL_TOL = 1e-5
PREFILL_TOL = 2e-5
DECODE_TOL = 5e-5
BF16_TOL = 2.0 ** -8
FAMILIES = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
            "falcon-mamba-7b", "zamba2-2.7b")


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(arch, capacity_factor=None):
    cfg, ref_cfg = smoke(get_config(arch)), ref_config.smoke(REF_ARCHS[arch])
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=capacity_factor))
    return cfg, ref_cfg


def both(ref_cfg, seed=0):
    """(port params, reference params), the reference's draw."""
    ref = ref_init_model(ref_cfg, jax.random.PRNGKey(seed))
    return model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), device="cpu"), ref


def tokens(cfg, b, s, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _dtypes(tree):
    return jax.tree_util.tree_map(
        lambda a: str(a.dtype).replace("torch.", ""), tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_and_loss_match_the_reference(arch):
    """prefill's hidden state, train_loss (with the MoE aux loss), and four
    decode steps from an f32 cache (logits, and every cache leaf)."""
    cfg, ref_cfg = configs(arch)
    params, ref_params = both(ref_cfg)
    tok = tokens(cfg, 2, 32)
    got = prefill(params, cfg, torch.from_numpy(tok).long())
    h, ref_aux = ref_backbone(ref_params, ref_cfg, jnp.asarray(tok))
    assert got.shape == h.shape and got.dtype == torch.float32
    assert normwise(got.numpy(), h) <= PREFILL_TOL
    _, aux = backbone(params, cfg, torch.from_numpy(tok).long())
    assert (float(ref_aux) == 0.0) == (cfg.family != "moe")
    assert abs(float(aux) - float(ref_aux)) <= MODEL_TOL * max(
        abs(float(ref_aux)), 1.0)

    labels = np.roll(tok, -1, 1)
    got = float(train_loss(params, cfg, {
        "tokens": torch.from_numpy(tok).long(),
        "labels": torch.from_numpy(labels).long()}))
    want = float(ref_train_loss(ref_params, ref_cfg, {
        "tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}))
    assert abs(got - want) <= MODEL_TOL * abs(want)

    step = jax.jit(lambda p, t, c, i: ref_decode_step(p, ref_cfg, t, c, i))
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    ref_cache = ref_init_cache(ref_cfg, 2, 16, jnp.float32)
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_equals_the_last_position_of_prefill(arch):
    """Teacher-forced decode with slots at different positions (per-slot
    ``cur_len``): each step's logits equal the full forward's at that
    slot's position, the prefill crossing smoke chunk boundaries (16) of
    the SSM scan.  The MoE configs take capacity factor 16, as the
    reference's own decode test does, so no pair drops on either side.
    Held at DECODE_TOL = 5e-5 normwise (the reference's own test holds
    2e-3 elementwise): the port's one-token attention and its chunked
    full-sequence attention round differently, and the difference grows
    with the position and the depth; qwen3-moe measures up to 3.3e-5 at
    position 28 (its 1e-5 is passed at position 7), the other three at
    most 1e-5, granite-20b 5.6e-6 on the same walk."""
    cfg, _ = configs(arch, 16.0 if "moe" in arch else None)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    s = 32
    tok = torch.from_numpy(tokens(cfg, 2, s, seed=3)).long()
    h, _ = backbone(params, cfg, tok)
    full = lm_logits(params["unembed"], cfg, h)[..., :cfg.vocab]
    cache = init_cache(cfg, 2, s, dtype=torch.float32, device="cpu")
    start = torch.tensor([0, 3])
    for t in range(s + 3):
        cur = (t - start).clamp(min=0, max=s - 1)
        step = tok[torch.arange(2), cur][:, None]
        logits, new_cache = decode_step(params, cfg, step, cache,
                                        cur.to(torch.int32))
        # a slot past its last token (or not yet started) keeps its state
        live = (t >= start) & (t - start < s)
        cache = jax.tree_util.tree_map(
            lambda n, o: torch.where(
                live.reshape((1, 2) + (1,) * (n.dim() - 2)), n, o),
            new_cache, cache)
        for b in range(2):
            if live[b]:
                assert normwise(logits[b, 0, :cfg.vocab].numpy(),
                                full[b, int(cur[b])].numpy()) <= DECODE_TOL
    if cfg.family == "moe":
        return
    # the host-loop spelling is the same loop
    loop, _ = decode_step_loop(params, cfg, step, cache, cur.to(torch.int32))
    assert torch.equal(loop, decode_step(params, cfg, step, cache,
                                         cur.to(torch.int32))[0])


def _with_memory(params, ref_params, cache, ref_cache, seed=4):
    """The cross families' inputs: every ``xgate`` at 0.7 on both sides (its
    init, 0, would leave the VLM's cross path out), and the cache's memory
    K/V ``xk``/``xv`` the same normal values in both, rounded to the
    cache's dtype by each package."""
    rng = np.random.default_rng(seed)
    for key, sub in params["blocks"].items():
        if "xgate" in sub:
            sub["xgate"] = torch.full_like(sub["xgate"], 0.7)
            ref_params["blocks"][key]["xgate"] = jnp.full_like(
                ref_params["blocks"][key]["xgate"], 0.7)
        if "xattn" not in sub:
            continue
        for name in ("xk", "xv"):
            old = ref_cache[key][name]
            x = rng.normal(size=old.shape).astype(np.float32)
            ref_cache[key][name] = jnp.asarray(x, old.dtype)
            cache[key][name] = torch.from_numpy(x).to(cache[key][name].dtype)
    return params, ref_params, cache, ref_cache


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b", "zamba2-2.7b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_bf16_cache_decode_matches_the_reference(arch):
    """``init_cache``'s bf16 default in both packages: 9 steps at B = 3,
    slots starting 0, 2 and 5 ticks late (per-slot ``cur_len``); every
    step's logits within BF16_TOL normwise, and the returned cache's dtypes
    the reference's after each step.  The cross families' cache holds the
    memory's K/V in bf16 too."""
    cfg, ref_cfg = configs(arch)
    params, ref_params = both(ref_cfg)
    tok = tokens(cfg, 3, 12, seed=1)
    start = np.array([0, 2, 5])
    step = jax.jit(lambda p, t, c, i: ref_decode_step(p, ref_cfg, t, c, i))
    cache = init_cache(cfg, 3, 16, device="cpu")
    ref_cache = ref_init_cache(ref_cfg, 3, 16)
    if cfg.family in ("vlm", "encdec"):
        params, ref_params, cache, ref_cache = _with_memory(
            params, ref_params, cache, ref_cache)
    assert _dtypes(cache) == jax.tree_util.tree_map(
        lambda a: str(a.dtype), ref_cache)
    for t in range(9):
        cur = np.maximum(t - start, 0).astype(np.int32)
        tk = tok[np.arange(3), cur][:, None]
        got, cache = decode_step(params, cfg, torch.from_numpy(tk).long(),
                                 cache, torch.from_numpy(cur))
        want, ref_cache = step(ref_params, jnp.asarray(tk), ref_cache,
                               jnp.asarray(cur))
        assert normwise(got[..., :cfg.vocab].numpy(),
                        np.asarray(want)[..., :cfg.vocab]) <= BF16_TOL, t
        assert _dtypes(cache) == jax.tree_util.tree_map(
            lambda a: str(a.dtype), ref_cache), t
    if cfg.ssm:
        assert cache["l0"]["conv"].dtype == torch.float32
