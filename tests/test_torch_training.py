"""The port's training substrate (``repro_torch.training``) against the
JAX package's, on the CPU: the reference's optimizer, schedule, data and
checkpoint tests (``tests/test_training.py``), each mirrored on the port
(its ``Trainer`` tests are in ``tests/test_torch_training_loop.py``), then
the pieces
held against the reference on the same inputs: ``synth_batch`` bit for
bit, ``warmup_cosine`` within one f32 ulp, ``adamw_update`` over ten steps
(f32 and 8-bit moments), and checkpoints that each package writes and the
other restores.

Tolerances.  The optimizer's arithmetic is the reference's, operation for
operation in f32, but XLA on the CPU contracts some products and sums into
fused multiply-adds and divides ``max|x|`` by 127 through a reciprocal, and
reduces the gradient norm's sum of squares in another order; so params and
f32 moments differ in the last places, and ten steps stay within
ADAM_RTOL = 1e-6.  The 8-bit moments' ``scale`` differs by up to 8 ulps
(measured), within ADAM_RTOL.  Their ``q`` is ``round(x / scale)``: a
quotient within a few ulps of k + 1/2 could round the other way, and
nowhere else can ``q`` differ.  On these inputs, clipped or not, no
quotient is that close to a tie: the count of differing ``q`` is 0, and
the test holds it there.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.training import adamw_init as ref_adamw_init
from repro.training import constant as ref_constant
from repro.training import adamw_update as ref_adamw_update
from repro.training import restore_checkpoint as ref_restore_checkpoint
from repro.training import save_checkpoint as ref_save_checkpoint
from repro.training import synth_batch as ref_synth_batch
from repro.training import warmup_cosine as ref_warmup_cosine
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.data import DataConfig as RefDataConfig
from repro_torch.convert import train_state_from_reference
from repro_torch.training import (
    AdamWConfig, DataConfig, SyntheticLoader, adamw_init, adamw_update,
    constant, latest_checkpoint, restore_checkpoint, save_checkpoint,
    synth_batch, warmup_cosine,
)
from repro_torch.training.tree import tree_map, tree_paths
from torch_training_parity import one_thread  # noqa: F401

ADAM_RTOL = 1e-6


def grad_of(loss, params):
    """The gradient tree of ``loss(params)`` (params as leaves)."""
    diff = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = list(tree_paths(diff).values())
    grads = iter(torch.autograd.grad(loss(diff), leaves))
    return tree_map(lambda _: next(grads), diff)


# ---------------------------------------------------------------------------
# the reference's tests, mirrored on the port
# ---------------------------------------------------------------------------


def _quad_params():
    return {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]),
            "b": torch.tensor([0.1, -0.1])}


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = _quad_params()
    state = adamw_init(params, cfg)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(50):
        g = grad_of(loss, params)
        params, state = adamw_update(g, state, params, cfg, cfg.lr)
    assert float(loss(params)) < l0 * 0.01


def test_adamw_quantized_matches_fp32_approximately():
    base = AdamWConfig(lr=0.01, weight_decay=0.0)
    quant = AdamWConfig(lr=0.01, weight_decay=0.0, quantize_moments=True)
    params_a = _quad_params()
    params_b = tree_map(torch.clone, params_a)
    sa, sb = adamw_init(params_a, base), adamw_init(params_b, quant)
    # moments of 2-D leaves are quantized, 1-D leaves stay fp32
    assert isinstance(sb["m"]["w"], dict)
    assert sb["m"]["w"]["q"].dtype == torch.int8
    assert not isinstance(sb["m"]["b"], dict)

    def loss(p):
        return torch.sum((p["w"] - 1.0) ** 2) + torch.sum(p["b"] ** 2)

    for _ in range(30):
        ga = grad_of(loss, params_a)
        gb = grad_of(loss, params_b)
        params_a, sa = adamw_update(ga, sa, params_a, base, base.lr)
        params_b, sb = adamw_update(gb, sb, params_b, quant, quant.lr)
    np.testing.assert_allclose(params_a["w"].numpy(), params_b["w"].numpy(),
                               atol=0.05)


def test_grad_clip_caps_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    params = _quad_params()
    before = tree_map(torch.clone, params)   # the update is in place
    state = adamw_init(params, cfg)
    huge = tree_map(lambda p: 1e9 * torch.ones_like(p), params)
    new_params, _ = adamw_update(huge, state, params, cfg, 1e-3)
    assert new_params is params
    delta = [float((a - b).abs().max()) for a, b in
             zip(tree_paths(new_params).values(),
                 tree_paths(before).values())]
    assert 0.0 < max(delta) < 1.0


def test_schedule_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1e-3, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert abs(max(lrs) - 1e-3) < 1e-9
    assert lrs[-1] < lrs[50] < lrs[10]


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab=101, seq_len=32, global_batch=4, seed=7)
    b1 = synth_batch(cfg, 5)
    b2 = synth_batch(cfg, 5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    loader = SyntheticLoader(cfg, device="cpu")
    for _ in range(3):
        next(loader)
    state = loader.state()
    b_next = next(loader)
    assert b_next["tokens"].dtype == torch.int32
    resumed = SyntheticLoader.restore(cfg, state, device="cpu")
    assert torch.equal(next(resumed)["tokens"], b_next["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLoader.restore(dataclasses.replace(cfg, seed=8), state,
                                device="cpu")


def test_data_is_learnable_structure():
    cfg = DataConfig(vocab=53, seq_len=64, global_batch=8, seed=0, noise=0.0)
    b = synth_batch(cfg, 0)
    # with zero noise, labels are a deterministic function of tokens
    t, l = b["tokens"][0], b["labels"][0]
    assert (t[1:] == l[:-1]).all()


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    for step in (1, 2, 3, 4):
        save_checkpoint(d, step, tree, extra={"x": step}, keep=2)
    assert latest_checkpoint(d).endswith("step_00000004")
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2
    template = tree_map(torch.zeros_like, tree)
    restored, step, extra = restore_checkpoint(latest_checkpoint(d), template)
    assert step == 4 and extra == {"x": 4}
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.ones((8, 8))}
    path = save_checkpoint(d, 1, tree)
    # corrupt a leaf
    victim = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    data = np.load(os.path.join(path, victim))
    data[0, 0] += 1
    np.save(os.path.join(path, victim), data)
    with pytest.raises(IOError):
        restore_checkpoint(path, tree)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,noise", [
    (0, 0, 0.1), (7, 5, 0.1), (3, 1000, 0.0), (11, 2 ** 31, 0.5)])
def test_synth_batch_equals_the_reference(seed, step, noise):
    for vocab, seq, batch in ((101, 32, 4), (151936, 16, 3)):
        got = synth_batch(DataConfig(vocab, seq, batch, seed, noise), step)
        want = ref_synth_batch(RefDataConfig(vocab, seq, batch, seed, noise),
                               step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_warmup_cosine_within_one_ulp():
    kw = dict(peak_lr=3e-4, warmup_steps=20, total_steps=100)
    got = np.array([float(warmup_cosine(s, **kw)) for s in range(120)],
                   np.float32)
    want = np.array([ref_warmup_cosine(jnp.int32(s), **kw)
                     for s in range(120)], np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps


def test_constant_schedule_equals_the_reference():
    for step in (0, 7):
        got = constant(step, peak_lr=3e-4, warmup_steps=5)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(ref_constant(jnp.int32(step),
                                                peak_lr=3e-4))


def _adam_tree(rng):
    """Params and ten gradient trees, numpy: a stacked 3-D leaf, 2-D
    matrices (weight decay, 8-bit moments) and 1-D leaves."""
    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)

    params = {"blocks": {"w": draw(3, 16, 24), "norm": draw(3, 24)},
              "embed": draw(40, 16), "bias": draw(24)}
    grads = [tree_map(lambda p: (0.1 * rng.normal(size=p.shape)).astype(
        np.float32), params) for _ in range(10)]
    return params, grads


@pytest.mark.parametrize("quantize,grad_clip", [
    (False, 1.0), (False, 1e6), (True, 1.0), (True, 1e6)])
def test_adamw_update_matches_the_reference(quantize, grad_clip):
    """Ten steps from one state on the same gradients: params, f32 moments
    and 8-bit scales within ADAM_RTOL; 8-bit ``q`` equal but at rounding
    ties, of which these inputs meet 0 (module docstring).  ``grad_clip``
    1 clips every step (the gradient norm is about 4), 1e6 none."""
    params, grads = _adam_tree(np.random.default_rng(0))
    kw = dict(lr=1e-2, quantize_moments=quantize, grad_clip=grad_clip)
    cfg, ref_cfg = AdamWConfig(**kw), RefAdamWConfig(**kw)
    # copies: the update is in place, and jnp.asarray may alias numpy
    p = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    state = adamw_init(p, cfg)
    rp = tree_map(jnp.asarray, params)
    rstate = ref_adamw_init(rp, ref_cfg)
    update = jax.jit(ref_adamw_update, static_argnums=3)
    for i, g in enumerate(grads):
        lr = float(warmup_cosine(i, peak_lr=1e-2, warmup_steps=3,
                                 total_steps=10))
        p, state = adamw_update(tree_map(torch.from_numpy, g), state, p,
                                cfg, lr)
        rp, rstate = update(tree_map(jnp.asarray, g), rstate, rp, ref_cfg,
                            lr)
    assert int(state["step"]) == int(rstate["step"]) == 10
    got = tree_paths({"params": p, "opt": state})
    want = tree_paths(jax.tree_util.tree_map(
        np.asarray, {"params": rp, "opt": rstate}))
    assert got.keys() == want.keys()
    assert any(k.endswith("/q") for k in want) == quantize
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        if k.endswith("/q"):
            assert np.count_nonzero(g != w) == 0, k
        else:
            np.testing.assert_allclose(g, w, rtol=ADAM_RTOL, atol=1e-7,
                                       err_msg=k)


def _mixed_tree():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "opt": {"step": np.array(7, np.int32),
                    "q": rng.integers(-127, 128, (4, 6)).astype(np.int8)},
            "h": rng.normal(size=(2, 8)).astype(np.float32)}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    """f32, int32, int8 and bf16 leaves written by the reference come back
    in the port bit for bit, in the template's dtypes, and the reference's
    own restore agrees."""
    tree = _mixed_tree()
    ref_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_tree["h"] = ref_tree["h"].astype(jnp.bfloat16)
    path = ref_save_checkpoint(str(tmp_path / "ref"), 3, ref_tree,
                               extra={"data": {"step": 3, "seed": 0}})
    template = {"w": torch.zeros(3, 5),
                "opt": {"step": torch.zeros((), dtype=torch.int32),
                        "q": torch.zeros((4, 6), dtype=torch.int8)},
                "h": torch.zeros((2, 8), dtype=torch.bfloat16)}
    got, step, extra = restore_checkpoint(path, template)
    assert step == 3 and extra == {"data": {"step": 3, "seed": 0}}
    want = tree_paths(jax.tree_util.tree_map(np.asarray, ref_tree))
    for k, g in tree_paths(got).items():
        assert g.dtype == template_dtype(template, k)
        np.testing.assert_array_equal(_bits(g), _bits(want[k]), err_msg=k)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    """The other way round: the port writes, the reference restores (its
    checksums over the same bytes), and the manifests agree."""
    tree = tree_map(torch.from_numpy, _mixed_tree())
    tree["h"] = tree["h"].to(torch.bfloat16)
    path = save_checkpoint(str(tmp_path / "port"), 3, tree,
                           extra={"data": {"step": 3, "seed": 0}})
    ref_tree = jax.tree_util.tree_map(jnp.asarray, _mixed_tree())
    ref_tree["h"] = ref_tree["h"].astype(jnp.bfloat16)
    template = jax.tree_util.tree_map(jnp.zeros_like, ref_tree)
    got, step, extra = ref_restore_checkpoint(path, template)
    assert step == 3 and extra == {"data": {"step": 3, "seed": 0}}
    for k, g in tree_paths(jax.tree_util.tree_map(np.asarray, got)).items():
        np.testing.assert_array_equal(_bits(g), _bits(tree_paths(tree)[k]),
                                      err_msg=k)
    ref_path = ref_save_checkpoint(str(tmp_path / "ref"), 3, ref_tree,
                                   extra={"data": {"step": 3, "seed": 0}})
    with open(os.path.join(path, "manifest.json")) as f, \
            open(os.path.join(ref_path, "manifest.json")) as g:
        assert f.read() == g.read()


def template_dtype(template, key):
    return tree_paths(template)[key].dtype


def _bits(a) -> np.ndarray:
    """The raw bytes of a tensor or an array (bf16 as its two bytes)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16 or a.dtype.kind == "V":
        a = a.view(np.int16)
    return np.ascontiguousarray(a).view(np.uint8)


def test_a_reference_train_state_converts_with_its_dtypes():
    """``train_state_from_reference`` carries a reference train state
    (8-bit moments included) across in each leaf's own dtype."""
    from repro.configs import ARCHS
    from repro.models import config as ref_config
    from repro.training import TrainConfig as RefTrainConfig
    from repro.training import init_train_state as ref_init_train_state

    ref_cfg = ref_config.smoke(ARCHS["qwen2-0.5b"])
    tc = RefTrainConfig(opt=RefAdamWConfig(quantize_moments=True))
    ref = jax.tree_util.tree_map(
        np.asarray, ref_init_train_state(ref_cfg, tc,
                                         jax.random.PRNGKey(0)))
    got = train_state_from_reference(ref, device="cpu")
    want = tree_paths(ref)
    assert tree_paths(got).keys() == want.keys()
    for k, g in tree_paths(got).items():
        assert g.numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(g.numpy(), want[k], err_msg=k)
