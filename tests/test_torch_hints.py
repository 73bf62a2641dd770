"""The port's sharding hints (``repro_torch.distributed.hints``) against the
JAX package's, on the CPU.

The reference's hints call ``with_sharding_constraint`` under the active
mesh; here its ``current_mesh``, ``_manual_axes`` and
``jax.lax.with_sharding_constraint`` are patched inside each test, so that
a trace (``jax.eval_shape``) over a ``tests/test_distributed.py``-style
mesh stand-in records each constraint's shape and spec.  The port's hints
record ``(site, shape, spec)`` on the active mesh's context; the two
records must agree hint for hint, in order, at every hint site of one rep
of qwen2-0.5b (14 heads, 2 KV heads: the non-divisible fallback) and of
qwen3-moe-30b-a3b (the dispatch buffers) at published widths, on the
16x16 and 2x16x16 meshes, at batch sizes that take each of ``_dp_part``'s
fallbacks.  The port runs on meta tensors.  Nothing in ``src/repro``
changes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.distributed.hints as ref_hints
from repro.configs import ARCHS as REF_ARCHS
from repro.models import abstract_model as ref_abstract_model
from repro.models.blocks import stage_forward as ref_stage_forward
from repro.models.blocks import superblock_table as ref_superblock_table

import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_config
from repro_torch.distributed.hints import hint, hint_heads
from repro_torch.launch.mesh import Mesh, current_mesh, make_host_mesh, \
    make_production_mesh, pipeline_stage
from repro_torch.models import abstract_model, smoke
from repro_torch.models.blocks import stage_forward, superblock_table
from repro_torch.models.config import ShapeConfig

ARCHS = ("qwen2-0.5b", "qwen3-moe-30b-a3b")
MESHES = {"16x16": False, "2x16x16": True}
#: (B, S): 32 divides pod x data, 2 only pod, 1 nothing
BATCHES = ((32, 64), (2, 64), (1, 128))


def ref_mesh(multi_pod: bool):
    """Axis-size metadata stand-in for the reference (no devices needed for
    spec math), as ``tests/test_distributed.py`` builds it."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))

    class M:
        axis_names = axes
        devices = np.empty(shape, object)

    return M()


def one_rep(cfg):
    """``cfg`` at published widths with one super-block rep."""
    return dataclasses.replace(cfg, n_layers=len(superblock_table(cfg)[1]))


def ref_record(monkeypatch, arch, multi_pod, b, s):
    """The reference's constraints, in order, over one rep of ``arch``."""
    cfg = REF_ARCHS[arch]
    cfg = dataclasses.replace(cfg, n_layers=len(ref_superblock_table(cfg)[1]))
    seen = []

    def constrain(x, spec):
        seen.append((tuple(x.shape), tuple(spec)))
        return x

    monkeypatch.setattr(ref_hints, "current_mesh",
                        lambda: ref_mesh(multi_pod))
    monkeypatch.setattr(ref_hints, "_manual_axes", lambda: False)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", constrain)
    _, kinds, _, _ = ref_superblock_table(cfg)
    blocks = ref_abstract_model(cfg, jnp.float32)["blocks"]
    h = jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.float32)
    jax.eval_shape(
        lambda p, x: ref_stage_forward(p, None, cfg, kinds, x)[0], blocks, h)
    return seen


def port_record(arch, multi_pod, b, s):
    """The port's hints, in order, over one rep of ``arch`` on meta."""
    cfg = one_rep(get_config(arch))
    _, kinds, _, _ = superblock_table(cfg)
    blocks = abstract_model(cfg, torch.float32)["blocks"]
    h = torch.empty((b, s, cfg.d_model), device="meta")
    with make_production_mesh(multi_pod=multi_pod) as ctx, torch.no_grad():
        out = stage_forward(blocks, None, cfg, kinds, h)[0]
    assert out.shape == h.shape
    return ctx.hints


@pytest.mark.parametrize("b,s", BATCHES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_hint_specs_equal_the_references(monkeypatch, arch, mesh, b, s):
    want = ref_record(monkeypatch, arch, MESHES[mesh], b, s)
    got = port_record(arch, MESHES[mesh], b, s)
    assert [(shape, tuple(spec)) for _, shape, spec in got] == want
    sites = [site for site, _, _ in got]
    expected = {"stage_forward", "attention"} | (
        {"moe_ffn"} if "moe" in arch else set())
    assert set(sites) == expected
    # the residual stream once a rep, then attention's q, k, v, q, k, out
    assert sites[:7] == ["stage_forward"] + ["attention"] * 6
    if "moe" in arch:
        assert sites[7:] == ["moe_ffn"] * 4


def test_head_fallback_and_dp_parts_are_exercised(monkeypatch):
    """qwen2-0.5b's 2 KV heads of 7 query heads divide no model axis of 16:
    attention stays unsharded on heads; its output's 896 goes on model; the
    batch takes ("pod", "data"), "pod" or nothing."""
    got = {b: port_record("qwen2-0.5b", True, b, 64) for b in (32, 2, 1)}
    for b, dp in ((32, ("pod", "data")), (2, "pod"), (1, None)):
        specs = [tuple(spec) for _, _, spec in got[b]]
        assert specs[0] == (dp, None, None)
        assert specs[1] == (dp, None, None, None, None)       # q
        assert specs[2] == (dp, None, None, None)             # k
        assert specs[6] == (dp, None, "model")                # out


def test_hint_returns_x_itself_and_records_only_on_a_real_mesh():
    x = torch.zeros((32, 4, 64))
    assert current_mesh() is None
    assert hint(x, "dp", None, "model") is x
    assert hint_heads(x, head_dims=(1,)) is x
    with make_host_mesh("cpu") as ctx:       # (1, 1): returns at once
        assert current_mesh() is ctx.mesh
        assert hint(x, "dp", None, "model") is x
        assert hint_heads(x, head_dims=(1,)) is x
    assert ctx.hints == []
    mesh = make_production_mesh()
    with mesh as ctx:
        assert hint(x, "dp", None, "model") is x
        assert hint(x, "dp", None) is x       # rank mismatch: no record
        with pipeline_stage():
            assert current_mesh() is mesh
            assert hint(x, "dp", None, "model") is x
            assert hint_heads(x) is x
        assert hint_heads(x, head_dims=(1,)) is x
    assert current_mesh() is None
    assert [(site, shape, tuple(spec)) for site, shape, spec in ctx.hints] \
        == [("test_hint_returns_x_itself_and_records_only_on_a_real_mesh",
             (32, 4, 64), ("data", None, "model")),
            ("test_hint_returns_x_itself_and_records_only_on_a_real_mesh",
             (32, 4, 64), ("data", None, None))]


def test_meshes_nest_per_thread():
    import threading

    outer, inner = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    seen = []
    with outer:
        with inner:
            assert current_mesh() is inner
            t = threading.Thread(target=lambda: seen.append(current_mesh()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        assert current_mesh() is outer
    assert current_mesh() is None and seen == [None]
    pipe = Mesh(("pod",), (2,), ("cpu",))
    with pipe as ctx:
        assert ctx.mesh is pipe and not ctx.manual


def test_a_dry_run_trace_with_hints_equals_one_without():
    """Hints change nothing in a trace: the same flops and output shapes
    under the production mesh (hints recorded) as under a (1, 1) mesh
    (hints return at once)."""
    cfg = smoke(get_config("qwen3-moe-30b-a3b"))
    shape = ShapeConfig("small", 64, 32, "prefill")
    with_hints = dr.Cell(cfg, shape, make_production_mesh(multi_pod=True))
    out, _, flops = with_hints.trace()
    assert len(with_hints.hints) > 0
    without = dr.Cell(cfg, shape, make_host_mesh("meta"))
    out2, _, flops2 = without.trace()
    assert without.hints == []
    assert flops == flops2 > 0
    assert out.shape == out2.shape and out.device.type == "meta"


def test_a_decode_step_makes_no_hint():
    """The serving step (``attention_decode``, the FFNs) calls no hint,
    as the reference's does not: under a recording mesh a dense decode
    step records nothing, a prefill records 7 a rep."""
    from repro_torch.models import decode_step, init_cache, init_model, \
        prefill

    cfg = smoke(get_config("qwen2-0.5b"))
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = init_cache(cfg, 2, 16, device="cpu")
    token = torch.zeros((2, 1), dtype=torch.long)
    with make_production_mesh() as ctx, torch.no_grad():
        logits, _ = decode_step(params, cfg, token, cache, 3)
    assert ctx.hints == [] and logits.shape[0] == 2
    with make_production_mesh() as ctx, torch.no_grad():
        prefill(params, cfg, torch.zeros((2, 8), dtype=torch.long))
    assert len(ctx.hints) == 7 * cfg.n_layers
