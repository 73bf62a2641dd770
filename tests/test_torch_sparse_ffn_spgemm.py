"""The spgemm path of the port's sparse FFN (``path="spgemm"``,
``sparsify_ffn_params``, the overlay in ``decode_step``/``prefill``) against
the JAX package's.

Weights are made with numpy from a seed (or drawn by the reference's
``init_model``) and carried across by ``convert.py``.  The port runs on the
CPU: the torch stream adds each C slot left to right there, as the
reference's ``segment_sum`` does.

What must be equal and what is held to a tolerance:
- pruning (``from_dense``, ``from_shared_pattern``, ``sparsify_ffn_params``)
  is host numpy in both packages: patterns bit for bit, values equal;
- the host-stream spelling (``apply_host``) runs the same numpy host stream
  as the reference's: bit for bit on the same inputs, also inside
  ``decode_step_loop(sparse_host=True)``, whose attention around the FFN is
  held to MODEL_TOL like the rest of the model;
- ``apply`` against the reference's ``apply`` within FFN_TOL = 1e-5 (the
  torch stream and XLA's segment sum add in the same order, but SiLU and
  the products may round differently in the last place);
- a batch against a loop of unbatched calls bit for bit (the torch
  stream's ``ALIGN``);
- the sparse decode against the dense decode on the densified weights at
  rtol 1e-4 / atol 1e-5, and gradients against the dense oracle at rtol
  1e-3, as the reference's own tests hold them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import decode_step as ref_decode_step
from repro.models import decode_step_loop as ref_decode_step_loop
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.models import prefill as ref_prefill
from repro.models.sparse_ffn import SparseFFN as RefSparseFFN
from repro.models.sparse_ffn import SparseMatmul as RefSparseMatmul
from repro.models.sparse_ffn import densify_ffn_params as ref_densify
from repro.models.sparse_ffn import sparsify_ffn_params as ref_sparsify
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference, \
    overlay_from_reference, sparse_matmul_from_reference
from repro_torch.core import plan_cache_clear
from repro_torch.models import SparseFFN, SparseMatmul, decode_step, \
    decode_step_loop, densify_ffn_params, init_cache, prefill, smoke, \
    sparsify_ffn_params
from repro_torch.models.blocks import superblock_table

FFN_TOL = 1e-5
MODEL_TOL = 1e-5
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
D, HID = 24, 32


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tiny_ffn_params(seed=0, d=D, hid=HID):
    """numpy FFN params in ``ffn_table``'s orientation (the reference
    tests' ``_tiny_ffn_params``, in f32)."""
    rng = np.random.default_rng(seed)
    return {"gate": {"w": rng.normal(size=(d, hid), scale=0.3)
                     .astype(np.float32)},
            "up": {"w": rng.normal(size=(d, hid), scale=0.3)
                   .astype(np.float32)},
            "down": {"w": rng.normal(size=(hid, d), scale=0.3)
                     .astype(np.float32)}}


def to_ref(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(seed=0, keep=0.4):
    """(port, reference) spgemm-path SparseFFNs of the same weights."""
    p = tiny_ffn_params(seed)
    ref = RefSparseFFN.from_params(to_ref(p), keep_density=keep,
                                   path="spgemm")
    sp = SparseFFN.from_params(p, keep_density=keep, path="spgemm",
                               device="cpu")
    return sp, ref


def assert_same_csc(got, want):
    c = want.w_csc
    nnz = c.nnz
    np.testing.assert_array_equal(got.w_csc.row_indices,
                                  np.asarray(c.row_indices)[:nnz])
    np.testing.assert_array_equal(got.w_csc.col_ptr, np.asarray(c.col_ptr))
    assert got.w_csc.row_indices.dtype == np.int32
    np.testing.assert_array_equal(got.w_values.numpy(),
                                  np.asarray(c.values)[:nnz])
    assert got.shape == tuple(want.shape) and got.density == want.density
    assert got.flops_per_col == want.flops_per_col


def dense_w(m: SparseMatmul, values=None) -> torch.Tensor:
    """The dense pruned weight of a spgemm-path matmul (``W @ x``)."""
    c = m.w_csc
    rows = torch.from_numpy(c.row_indices.astype(np.int64))
    cols = torch.from_numpy(np.repeat(np.arange(c.shape[1]),
                                      np.diff(c.col_ptr)))
    v = m.w_values if values is None else values
    return torch.zeros(c.shape).index_put((rows, cols), v)


@pytest.fixture(scope="module", params=["granite-20b", "qwen2-0.5b"])
def sparse_model(request):
    """(port cfg, ref cfg, port sparse params, port overlay, ref sparse
    params, ref overlay) at smoke size, keep 0.5."""
    ref_cfg = ref_config.smoke(REF_ARCHS[request.param])
    ref_params = ref_init_model(ref_cfg, jax.random.PRNGKey(1))
    ref_sp, ref_ov = ref_sparsify(ref_cfg, ref_params, keep_density=0.5)
    cfg = smoke(get_config(request.param))
    params = model_params_from_reference(host(ref_params), device="cpu")
    sp, ov = sparsify_ffn_params(cfg, params, keep_density=0.5)
    return cfg, ref_cfg, sp, ov, ref_sp, ref_ov


# -- pruning and structure -------------------------------------------------------


@pytest.mark.parametrize("keep", [0.9, 0.4, 0.1])
@pytest.mark.parametrize("ties", [False, True])
def test_from_dense_spgemm_is_the_references(keep, ties):
    rng = np.random.default_rng(3)
    w = (rng.integers(-2, 3, size=(64, 96)) if ties
         else rng.normal(size=(64, 96))).astype(np.float32)
    got = SparseMatmul.from_dense(w, keep_density=keep, path="spgemm",
                                  stream_limit=1234, device="cpu")
    want = RefSparseMatmul.from_dense(w, keep_density=keep, path="spgemm")
    assert got.path == "spgemm" and got.stream_limit == 1234
    assert_same_csc(got, want)
    assert got.w_values.dtype == torch.float32


@pytest.mark.parametrize("keep", [0.5, 0.1])
def test_from_shared_pattern_is_the_references(keep):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 40, 56)).astype(np.float32)
    w[1, :5] = 7.0                       # ties across reps at the top
    got, gv = SparseMatmul.from_shared_pattern(w, keep_density=keep,
                                               device="cpu")
    want, wv = RefSparseMatmul.from_shared_pattern(w, keep_density=keep)
    assert_same_csc(got, want)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv.shape == (3, got.w_csc.nnz)
    with pytest.raises(ValueError, match="R, m, k"):
        SparseMatmul.from_shared_pattern(w[0], device="cpu")


def test_sparsify_is_the_references(sparse_model):
    """Patterns bit for bit, value stacks equal, the rest of the tree
    untouched; densify places the values back as the reference does."""
    cfg, ref_cfg, sp, ov, ref_sp, ref_ov = sparse_model
    assert sorted(ov) == sorted(ref_ov)
    for li in ov:
        for name in ("gate", "up", "down"):
            assert_same_csc(getattr(ov[li], name), getattr(ref_ov[li], name))
            np.testing.assert_array_equal(
                sp["blocks"][li]["ffn"][name].numpy(),
                np.asarray(ref_sp["blocks"][li]["ffn"][name]))
    np.testing.assert_array_equal(
        sp["blocks"]["l0"]["attn"]["wq"]["w"].numpy(),
        np.asarray(ref_sp["blocks"]["l0"]["attn"]["wq"]["w"]))
    got = densify_ffn_params(cfg, sp, ov)
    want = ref_densify(ref_cfg, ref_sp, ref_ov)
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            got["blocks"]["l0"]["ffn"][name]["w"].numpy(),
            np.asarray(want["blocks"]["l0"]["ffn"][name]["w"]))


def test_overlay_from_reference_runs_the_same_masks(sparse_model):
    cfg, _, sp, ov, _, ref_ov = sparse_model
    carried = overlay_from_reference(ref_ov, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, cfg.d_model)).astype(np.float32))
    for li in ov:
        for name in ("gate", "up", "down"):
            assert_same_csc(getattr(carried[li], name),
                            getattr(ref_ov[li], name))
        p0 = {k: v[0] for k, v in sp["blocks"][li]["ffn"].items()}
        assert torch.equal(carried[li].apply(p0, x), ov[li].apply(p0, x))


def test_sparse_matmul_from_reference_spgemm_branch():
    _, ref = pair(6)
    m = ref.gate
    c = m.w_csc
    got = sparse_matmul_from_reference(
        "spgemm", None, None, None, None, m.shape, m.density, device="cpu",
        w_csc=(np.asarray(c.values), np.asarray(c.row_indices),
               np.asarray(c.col_ptr)), stream_limit=77)
    assert_same_csc(got, m)
    assert got.stream_limit == 77
    with pytest.raises(ValueError, match="unknown path"):
        sparse_matmul_from_reference("csr", None, None, None, None,
                                     (4, 4), 1.0, device="cpu")


# -- forward, host stream, batches ----------------------------------------------


def test_apply_matches_the_reference():
    sp, ref = pair(1)
    rng = np.random.default_rng(2)
    for shape in ((6, D), (3, 5, D)):
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(ref.apply(ref.trainable_params(), jnp.asarray(x)))
        got = sp.apply(sp.trainable_params(), torch.from_numpy(x))
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=FFN_TOL,
                                   atol=FFN_TOL)
        np.testing.assert_allclose(sp(torch.from_numpy(x)).numpy(), want,
                                   rtol=FFN_TOL, atol=FFN_TOL)
    assert sp.flops_per_token == ref.flops_per_token


def test_apply_host_is_the_references_bit_for_bit():
    sp, ref = pair(3)
    rng = np.random.default_rng(4)
    for shape in ((7, D), (2, 3, D)):
        x = rng.normal(size=shape).astype(np.float32)
        want = ref.apply_host(ref.trainable_params(), x)
        got = sp.apply_host(sp.trainable_params(), torch.from_numpy(x))
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got, want)
        # the host spelling agrees with the stream spelling
        np.testing.assert_allclose(
            got, sp.apply(sp.trainable_params(), torch.from_numpy(x))
            .numpy(), rtol=FFN_TOL, atol=FFN_TOL)


def test_batched_equals_looped_bit_for_bit():
    sp, _ = pair(5)
    params = sp.trainable_params()
    xs = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 3, D)).astype(np.float32))
    got = sp.apply(params, xs)
    assert torch.equal(got, torch.stack([sp.apply(params, x) for x in xs]))
    assert torch.equal(sp(xs), torch.stack([sp(x) for x in xs]))
    m = sp.gate
    xt = xs.transpose(1, 2).contiguous()              # [B, D, T]
    assert torch.equal(m.batched(xt), torch.stack([m(x) for x in xt]))
    assert torch.equal(m.apply_values(m.w_values, xt),
                       torch.stack([m.apply_values(m.w_values, x)
                                    for x in xt]))


def test_plans_are_torch_plans_on_the_values_device_kept_per_token_count():
    plan_cache_clear()
    sp, _ = pair(7)
    m = sp.up
    for n in range(1, 11):
        m(torch.zeros((D, n)))
    assert len(m._spgemm_memo) == SparseMatmul.SPGEMM_MEMO_SIZE == 8
    plan, flat, _ = m._spgemm_memo[(10, "torch", "cpu")]
    assert plan.backend == "torch" and plan.method == "expand"
    assert plan.device == torch.device("cpu")
    assert flat.dtype == torch.int64
    assert plan.b.row_indices.dtype == np.int32
    assert plan.b.nnz == D * 10 and plan.stream.n_products == 10 * m.w_csc.nnz
    m.apply_values_host(m.w_values, np.zeros((D, 3), np.float32))
    assert m._spgemm_memo[(3, "host", "cpu")][0].backend == "host"
    # no kernel of ours runs on the CPU
    kernels.reset_launch_counts()
    sp(torch.zeros((2, 3, D)))
    assert set(kernels.launch_counts().values()) == {0}
    plan_cache_clear()


def test_gradients_match_the_dense_oracle():
    sp, _ = pair(2)
    params = {k: v.clone().requires_grad_(True)
              for k, v in sp.trainable_params().items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, D)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(5, D)).astype(np.float32))
    loss = ((sp.apply(params, x) - y) ** 2).mean()
    got = torch.autograd.grad(loss, [params[k] for k in ("gate", "up",
                                                         "down")])
    dense = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    silu = torch.nn.functional.silu
    w = {k: dense_w(getattr(sp, k), dense[k]) for k in dense}
    pred = (w["down"] @ (silu(w["gate"] @ x.T) * (w["up"] @ x.T))).T
    want = torch.autograd.grad(((pred - y) ** 2).mean(),
                               [dense[k] for k in ("gate", "up", "down")])
    for name, g, wg in zip(("gate", "up", "down"), got, want):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


# -- errors ----------------------------------------------------------------------


def test_stream_limit_error_and_override():
    w = np.random.default_rng(7).normal(size=(16, 16)).astype(np.float32)
    x = torch.ones((16, 4))
    tight = SparseMatmul.from_dense(w, path="spgemm", stream_limit=1,
                                    device="cpu")
    with pytest.raises(ValueError, match="stream_limit"):
        tight.apply_values(tight.w_values, x)
    with pytest.raises(ValueError, match="stream_limit"):
        tight.apply_values_host(tight.w_values, x.numpy())
    roomy = SparseMatmul.from_dense(w, path="spgemm", stream_limit=10**7,
                                    device="cpu")
    y = roomy.apply_values(roomy.w_values, x)
    assert y.shape == (16, 4) and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), dense_w(roomy).numpy() @ x.numpy(),
                               rtol=FFN_TOL, atol=FFN_TOL)


def test_trainable_params_and_paths_raise():
    sp = SparseFFN.from_params(tiny_ffn_params(6), keep_density=0.3,
                               t_density=0.75, device="cpu")
    with pytest.raises(ValueError, match="spgemm"):
        sp.trainable_params()
    with pytest.raises(ValueError, match="spgemm"):
        sp.gate.apply_values(torch.zeros(3), torch.zeros((D, 2)))
    with pytest.raises(ValueError, match="spgemm"):
        sp.gate.w_values
    with pytest.raises(ValueError, match="unknown path"):
        SparseMatmul.from_dense(np.eye(16, dtype=np.float32), path="bogus",
                                device="cpu")
    cfg = smoke(get_config("granite-20b"))
    with pytest.raises(ValueError, match="no stacked"):
        sparsify_ffn_params(cfg, {"blocks": {"l0": {}}})


def test_entry_points_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    w = np.ones((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseMatmul.from_dense(w, path="spgemm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseMatmul.from_shared_pattern(w[None])


# -- the overlay in the model ----------------------------------------------------


def _step_inputs(cfg):
    tok = np.array([[3], [5]], np.int32)
    cur = np.array([0, 2], np.int32)
    return tok, cur


def test_sparse_decode_matches_dense_reference(sparse_model):
    """decode_step with the overlay == decode_step on the densified
    weights, and the host-stream loop == the device-stream step (the
    reference's own test, in the port)."""
    cfg, _, sp, ov, _, _ = sparse_model
    dense_ref = densify_ffn_params(cfg, sp, ov)
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    tok, cur = (torch.from_numpy(a) for a in _step_inputs(cfg))
    ref, ref_cache = decode_step(dense_ref, cfg, tok.long(), cache, cur)
    got, got_cache = decode_step(sp, cfg, tok.long(), cache, cur,
                                 sparse_ffn=ov)
    loop, _ = decode_step_loop(sp, cfg, tok.long(), cache, cur,
                               sparse_ffn=ov, sparse_host=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(loop.numpy(), got.numpy(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    assert torch.equal(got_cache["l0"]["k"][:, 0, 1:],
                       torch.zeros_like(got_cache["l0"]["k"][:, 0, 1:]))
    assert got_cache["l0"]["k"][:, 1, 2].abs().sum() > 0


def test_sparse_decode_and_prefill_match_the_reference(sparse_model):
    """The overlay's device stream (decode_step, prefill) against the
    reference's XLA stream within MODEL_TOL normwise; the host-stream loop
    against the reference's host-stream loop, each FFN call bit for bit on
    the same input."""
    cfg, ref_cfg, sp, ov, ref_sp, ref_ov = sparse_model
    tok, cur = _step_inputs(cfg)
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    ref_cache = ref_init_cache(ref_cfg, 2, 16, jnp.float32)
    got, _ = decode_step(sp, cfg, torch.from_numpy(tok).long(), cache,
                         torch.from_numpy(cur), sparse_ffn=ov)
    want, _ = ref_decode_step(ref_sp, ref_cfg, jnp.asarray(tok), ref_cache,
                              jnp.asarray(cur), sparse_ffn=ref_ov)
    assert normwise(got.numpy()[..., :cfg.vocab],
                    np.asarray(want)[..., :cfg.vocab]) <= MODEL_TOL

    calls = []
    apply_host = SparseFFN.apply_host

    def recording(self, params, x):
        y = apply_host(self, params, x)
        if isinstance(x, torch.Tensor):          # the [B, 1, D] call
            calls.append((self, {k: v.numpy() for k, v in params.items()},
                          x.numpy(), y))
        return y

    SparseFFN.apply_host = recording
    try:
        got, _ = decode_step_loop(sp, cfg, torch.from_numpy(tok).long(),
                                  cache, torch.from_numpy(cur),
                                  sparse_ffn=ov, sparse_host=True)
    finally:
        SparseFFN.apply_host = apply_host
    want, _ = ref_decode_step_loop(ref_sp, ref_cfg, jnp.asarray(tok),
                                   ref_cache, jnp.asarray(cur),
                                   sparse_ffn=ref_ov, sparse_host=True)
    assert normwise(got.numpy()[..., :cfg.vocab],
                    np.asarray(want)[..., :cfg.vocab]) <= MODEL_TOL
    _, _, n_rep, _ = superblock_table(cfg)
    assert len(calls) == n_rep
    for _, params, x, y in calls:
        np.testing.assert_array_equal(
            y, ref_ov["l0"].apply_host(to_ref(params), x))

    seq = np.random.default_rng(8).integers(0, cfg.vocab, (1, 6))
    got = prefill(sp, cfg, torch.from_numpy(seq).long(), sparse_ffn=ov)
    want = ref_prefill(ref_sp, ref_cfg, jnp.asarray(seq), sparse_ffn=ref_ov)
    assert normwise(got.numpy(), want) <= MODEL_TOL
