"""The port's model stack on bf16 params against the JAX package's, on the
CPU: the draws (``init_params`` / ``init_model`` / ``init_train_state``
with ``dtype=``), bf16 trees carried across by ``convert``, ``dense`` and
``rms_norm`` on bf16, and prefill and decode of the six families.  The
train steps, the overlay decode, the serving engine and the checkpoint of
a bf16 state are ``tests/test_torch_bf16_params_train.py``.

Weights are the reference's draw at smoke size, well scaled
(``torch_training_parity.family_model``), rounded to bf16 by XLA and
carried across by ``convert.model_params_from_reference``, which keeps a
bf16 leaf bf16.  Tokens are made with numpy from a seed.

Tolerances.  Each package rounds its bf16 intermediates (the residual
stream, each product's output, the SwiGLU's elementwise product) to 8
bits, and the two round some of them differently: ``dense`` and
``rms_norm`` agree bit for bit, but XLA's fused ``logistic`` in
``jax.nn.silu`` and PyTorch's ``silu`` differ by one bf16 ulp in about
40 % of the elements (C23), and a one-ulp difference in the residual
stream then grows through the layers as any other rounding does.  So the
two packages are not held to each other's bits: each is held to an f32
run on the same bf16-valued weights, the port's distance from it at most
``RATIO`` times the reference's own distance plus ``SLACK`` (measured 0.75
to 1.15 times, prefill and decode), and the two bf16 runs to ``BF16_TOL``
= 3e-2 normwise of each other (measured 1.2e-2 to 2.2e-2 for the prefill
logits and 9.8e-3 to 1.9e-2 for the decode steps', a few times u =
2^-8).  The f32 runs on the same weights keep the f32 stack's 1e-5 (C9).
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import decode_step as ref_decode_step
from repro.models import init_model as ref_init_model
from repro.models import prefill as ref_prefill
from repro.models.layers import dense as ref_dense
from repro.models.layers import lm_logits as ref_lm_logits
from repro.models.layers import rms_norm as ref_rms_norm
from repro.models.lm import _memory_from_aux as ref_memory_from_aux
from repro.training import TrainConfig as RefTrainConfig
from repro.training import init_train_state as ref_init_train_state
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference, \
    train_state_from_reference
from repro_torch.models import decode_step, init_cache, init_model, \
    prefill, smoke
from repro_torch.models.layers import dense, lm_logits, rms_norm
from repro_torch.models.params import init_params
from repro_torch.training import AdamWConfig, TrainConfig, \
    init_train_state
from repro_torch.training.tree import tree_paths
from torch_training_parity import FAMILIES, batch_for, family_model, \
    normwise, one_thread  # noqa: F401

BF16_TOL = 3e-2
RATIO = 1.5
SLACK = 2e-3
DECODE_STEPS = 4

#: crc32 of the f32 draws (``_crc``) from seed 3 at smoke size, as the
#: port drew them before ``dtype=`` existed: the default stays bit for bit
F32_DRAWS = {"qwen2-0.5b": 0x85ba98f8, "falcon-mamba-7b": 0x730dbfb9,
             "zamba2-2.7b": 0x29f348b9, "qwen3-moe-30b-a3b": 0x3816a640}
F32_STATE = 0xb4d55201   # qwen2-0.5b's train state, 8-bit moments


def _crc(tree) -> int:
    c = 0
    for k, t in sorted(tree_paths(tree).items()):
        c = zlib.crc32(k.encode(), c)
        c = zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8)
                       .numpy().tobytes(), c)
    return c


def bf16_tree(tree):
    """A numpy tree rounded to bf16 by XLA (``ml_dtypes.bfloat16``
    arrays)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), tree)


def widened(tree):
    """A numpy tree's values as f32 (exact from bf16)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# -- the draws -------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(F32_DRAWS))
def test_init_model_bf16_is_the_f32_draw_rounded(arch):
    """Every leaf bf16 and equal to the f32 draw from the same generator
    rounded once (``ssm_a``, ``dt_bias``, zeros and ones included); the
    f32 draw, the default, is the one the port made before ``dtype=``."""
    cfg = smoke(get_config(arch))
    f32 = init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert _crc(f32) == F32_DRAWS[arch]
    again = init_model(cfg, torch.Generator().manual_seed(3), device="cpu",
                       dtype=torch.float32)
    assert _crc(again) == F32_DRAWS[arch]
    b16 = init_model(cfg, torch.Generator().manual_seed(3), device="cpu",
                     dtype=torch.bfloat16)
    want = tree_paths(f32)
    assert tree_paths(b16).keys() == want.keys()
    for k, t in tree_paths(b16).items():
        assert t.dtype == torch.bfloat16, k
        assert torch.equal(t.view(torch.int16),
                           want[k].to(torch.bfloat16).view(torch.int16)), k


def test_init_params_rounds_to_nearest_even():
    """The rounding is XLA's convert: to nearest, ties to even, on the
    reference's ``_init_leaf`` kinds."""
    from repro.models.params import Leaf as RefLeaf
    from repro.models.params import init_params as ref_init_params
    from repro_torch.models.params import Leaf

    kinds = {"a": ("ssm_a", (3, 16)), "b": ("zeros", (5,)),
             "c": ("ones", (2, 3)), "d": ("normal:0.02", (64, 48))}
    table = {k: Leaf(s, (None,) * len(s), i) for k, (i, s) in kinds.items()}
    got = tree_paths(init_params(table, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.bfloat16))
    f32 = tree_paths(init_params(table, torch.Generator().manual_seed(0),
                                 device="cpu"))
    ref_table = {k: RefLeaf(s, (None,) * len(s), i)
                 for k, (i, s) in kinds.items()}
    ref = ref_init_params(ref_table, jax.random.PRNGKey(0), jnp.bfloat16)
    for k in ("a", "b", "c"):   # no draw: equal to the reference's bits
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))
    # the port's own normal draw rounded by XLA gives the same bits
    np.testing.assert_array_equal(
        got["d"].float().numpy(),
        np.asarray(jnp.asarray(f32["d"].numpy()).astype(jnp.bfloat16),
                   np.float32))


def test_init_train_state_takes_a_dtype():
    """bf16 params (the f32 draw rounded) beside f32 moments, int8 codes
    with f32 scales for the matrices; the f32 state is the parent's."""
    cfg = smoke(get_config("qwen2-0.5b"))
    tc = TrainConfig(opt=AdamWConfig(quantize_moments=True))
    f32 = init_train_state(cfg, tc, torch.Generator().manual_seed(3),
                           device="cpu")
    assert _crc(f32) == F32_STATE
    b16 = init_train_state(cfg, tc, torch.Generator().manual_seed(3),
                           device="cpu", dtype=torch.bfloat16)
    want = tree_paths(f32["params"])
    for k, t in tree_paths(b16["params"]).items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, want[k].to(torch.bfloat16)), k
    for k, t in tree_paths(b16["opt"]).items():
        assert t.dtype == tree_paths(f32["opt"])[k].dtype, k
        assert not t.any(), k
    assert {t.dtype for t in tree_paths(b16["opt"]).values()} == {
        torch.int32, torch.int8, torch.float32}


# -- carrying bf16 trees across --------------------------------------------


def test_model_params_from_reference_keeps_bf16():
    """A reference draw in bf16 comes across bf16, value for value; an f32
    one stays f32."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.models import config as ref_config

    ref_cfg = ref_config.smoke(REF_ARCHS["zamba2-2.7b"])
    for dtype, want_dtype in ((jnp.bfloat16, torch.bfloat16),
                              (jnp.float32, torch.float32)):
        ref = jax.tree_util.tree_map(np.asarray, ref_init_model(
            ref_cfg, jax.random.PRNGKey(2), dtype))
        got = tree_paths(model_params_from_reference(ref, device="cpu"))
        want = tree_paths(ref)
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.dtype == want_dtype, k
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(want[k], np.float32))


def test_train_state_from_reference_takes_bf16_params():
    """A reference train state on bf16 params (8-bit moments) converts, each
    leaf in its own dtype, bf16 values exact.  The port used to raise
    ``TypeError: can't convert np.ndarray of type ml_dtypes.bfloat16``."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.models import config as ref_config

    ref_cfg = ref_config.smoke(REF_ARCHS["qwen2-0.5b"])
    tc = RefTrainConfig(opt=RefAdamWConfig(quantize_moments=True))
    ref = jax.tree_util.tree_map(np.asarray, ref_init_train_state(
        ref_cfg, tc, jax.random.PRNGKey(0), jnp.bfloat16))
    got = tree_paths(train_state_from_reference(ref, device="cpu"))
    want = tree_paths(ref)
    assert got.keys() == want.keys()
    for k, t in got.items():
        if k.startswith("params/"):
            assert t.dtype == torch.bfloat16, k
        else:
            assert t.numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[k], np.float32))


# -- the layers on bf16 ------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_dense_and_rms_norm_on_bf16_are_the_references(bias):
    """A bf16 GEMM with f32 sums and a bf16 result, and the norm's f32
    variance with a bf16 data path: bit for bit the reference's."""
    rng = np.random.default_rng(6)
    p = {"w": rng.normal(size=(96, 80)).astype(np.float32) / 10}
    if bias:
        p["b"] = rng.normal(size=(80,)).astype(np.float32)
    x = rng.normal(size=(3, 5, 96)).astype(np.float32)
    scale = {"scale": rng.normal(size=(96,)).astype(np.float32)}
    b16 = bf16_tree({"p": p, "x": x, "s": scale})
    tp = model_params_from_reference(b16, device="cpu")
    got = dense(tp["p"], tp["x"])
    want = ref_dense(jax.tree_util.tree_map(jnp.asarray, b16["p"]),
                     jnp.asarray(b16["x"]))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    got = rms_norm(tp["s"], tp["x"], 1e-6)
    want = ref_rms_norm(jax.tree_util.tree_map(jnp.asarray, b16["s"]),
                        jnp.asarray(b16["x"]), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# -- the six families --------------------------------------------------------


def _four(arch):
    """(cfg, ref_cfg, {name: (port params, reference params)}) for the
    bf16 tree and its f32 widening."""
    cfg, ref_cfg, tree = family_model(arch)
    b16 = bf16_tree(tree)
    out = {}
    for name, t in (("bf16", b16), ("f32", widened(b16))):
        out[name] = (model_params_from_reference(t, device="cpu"),
                     jax.tree_util.tree_map(jnp.asarray, t))
    return cfg, ref_cfg, out


def _held(cfg, runs):
    """The two packages' bf16 runs within BF16_TOL of each other, and the
    port's distance from its f32 run within RATIO of the reference's
    distance from its own, plus SLACK."""
    v = cfg.vocab
    port, ref = runs["port"], runs["ref"]
    across = normwise(port["bf16"][..., :v], ref["bf16"][..., :v])
    d_port = normwise(port["bf16"][..., :v], port["f32"][..., :v])
    d_ref = normwise(ref["bf16"][..., :v], ref["f32"][..., :v])
    assert across <= BF16_TOL, (across, d_port, d_ref)
    assert d_port <= RATIO * d_ref + SLACK, (across, d_port, d_ref)
    # the f32 runs are the f32 stack's contract (C9)
    assert normwise(port["f32"][..., :v], ref["f32"][..., :v]) <= 1e-5
    return across, d_port, d_ref


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_on_bf16_params_matches_the_reference(arch):
    """The prefill's logits ([2, 32] tokens, ``aux`` for the cross
    families): bf16 residual stream, bf16 logits' input, f32 logits."""
    cfg, ref_cfg, both = _four(arch)
    batch = batch_for(cfg, 2, 32)
    runs = {"port": {}, "ref": {}}
    aux = batch.get("aux")
    for name, (params, ref_params) in both.items():
        dt, ref_dt = ((torch.bfloat16, jnp.bfloat16) if name == "bf16"
                      else (torch.float32, jnp.float32))
        h = prefill(params, cfg, torch.from_numpy(batch["tokens"]).long(),
                    None if aux is None else torch.from_numpy(aux).to(dt))
        assert h.dtype == dt
        runs["port"][name] = lm_logits(params["unembed"], cfg, h).numpy()
        ref_h = ref_prefill(ref_params, ref_cfg,
                            jnp.asarray(batch["tokens"]),
                            None if aux is None
                            else jnp.asarray(aux).astype(ref_dt))
        runs["ref"][name] = np.asarray(ref_lm_logits(
            ref_params["unembed"], ref_cfg, ref_h))
    _held(cfg, runs)


def _memory_cache(cfg, ref_cfg, f32_ref_params, tree, b, s):
    """An f32 cache (numpy, the serving engine's dtype) with each cross
    sub-layer's ``xk``/``xv`` the memory's projections through the f32
    widening of the bf16 weights, the same numbers for every run."""
    cache = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        init_cache(cfg, b, s, dtype=torch.float32, device="cpu"))
    if cfg.family not in ("vlm", "encdec"):
        return cache
    aux = batch_for(cfg, b, 4)["aux"]
    mem = np.asarray(ref_memory_from_aux(f32_ref_params, ref_cfg,
                                         jnp.asarray(aux)))
    for key, sub in tree["blocks"].items():
        if "xattn" not in sub:
            continue
        shape = (b, mem.shape[1], cfg.n_kv_heads, cfg.d_head)
        for name, w in (("xk", "wk"), ("xv", "wv")):
            ws = np.asarray(sub["xattn"][w]["w"], np.float32)
            cache[key][name] = np.stack(
                [(mem @ ws[r]).reshape(shape) for r in range(ws.shape[0])])
    return cache


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_on_bf16_params_matches_the_reference(arch):
    """``DECODE_STEPS`` decode steps at B = 2 from an f32 cache (the
    serving engine's), the cross families' holding the memory's K/V: each
    step's logits."""
    cfg, ref_cfg, both = _four(arch)
    _, _, tree = family_model(arch)
    tok = batch_for(cfg, 2, DECODE_STEPS, seed=2)["tokens"]
    start = _memory_cache(cfg, ref_cfg, both["f32"][1],
                          widened(bf16_tree(tree)), 2, 16)
    step = jax.jit(lambda p, t, c, i: ref_decode_step(p, ref_cfg, t, c, i))
    logs = {"port": {}, "ref": {}}
    for name, (params, ref_params) in both.items():
        cache = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a.copy()), start)
        ref_cache = jax.tree_util.tree_map(jnp.asarray, start)
        got, want = [], []
        for t in range(DECODE_STEPS):
            lg, cache = decode_step(params, cfg,
                                    torch.from_numpy(tok[:, t:t + 1]).long(),
                                    cache, t)
            rl, ref_cache = step(ref_params, jnp.asarray(tok[:, t:t + 1]),
                                 ref_cache, jnp.int32(t))
            assert lg.dtype == torch.float32
            got.append(lg.numpy())
            want.append(np.asarray(rl))
        logs["port"][name], logs["ref"][name] = got, want
        assert {str(t.dtype) for t in tree_paths(cache).values()} \
            == {"torch.float32"}
    for t in range(DECODE_STEPS):
        _held(cfg, {pkg: {name: log[t] for name, log in runs.items()}
                    for pkg, runs in logs.items()})
