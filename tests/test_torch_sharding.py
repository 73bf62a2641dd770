"""The port's model-side sharding (``repro_torch.distributed.sharding``, the
spec functions of ``models.params`` / ``models.lm`` / ``training.
optimizer``, ``launch.mesh`` and ``launch.specs``) against the JAX
package's: the twins of ``tests/test_distributed.py``'s spec tests, then
``model_specs``, ``abstract_model``, ``opt_state_specs``, ``batch_spec`` and
``cache_specs`` leaf for leaf for all ten architectures on the 16x16 and
2x16x16 meshes in both modes.  Shapes only (meta tensors and
``jax.eval_shape``): a few seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as rsh
from repro.models import abstract_model as ref_abstract_model
from repro.models import init_cache as ref_init_cache
from repro.models import model_specs as ref_model_specs
from repro.models import shapes_for as ref_shapes_for
from repro.models.params import Leaf as RefLeaf
from repro.models.params import _spec_for as ref_spec_for
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.optimizer import adamw_init as ref_adamw_init
from repro.training.optimizer import opt_state_specs as ref_opt_state_specs

from repro_torch.configs import ARCHS
from repro_torch.distributed.sharding import (
    NamedSharding, P, PartitionSpec, batch_spec, cache_specs, dp_axes,
    mesh_axis_sizes, param_sharding, sharding_rules)
from repro_torch.launch.mesh import make_host_mesh, \
    make_production_mesh
from repro_torch.launch.specs import decode_input_specs, \
    prefill_input_specs, train_input_specs
from repro_torch.models import abstract_model, init_cache, model_specs, \
    shapes_for
from repro_torch.models.params import Leaf, _spec_for
from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
    opt_state_specs
from repro_torch.training.tree import tree_paths

ARCH_NAMES = sorted(ARCHS)
MESHES = {"16x16": False, "2x16x16": True}


def ref_mesh(multi_pod: bool):
    """Axis-size metadata stand-in for the reference (no devices needed for
    spec math), as ``tests/test_distributed.py`` builds it."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))

    class M:
        axis_names = axes
        devices = np.empty(shape, object)

    return M()


def ref_paths(tree):
    """``{"/"-joined key path: leaf}`` of a reference tree whose leaves are
    ``PartitionSpec``s or arrays."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def port_paths(tree):
    """The same of a port tree (``PartitionSpec`` is a tuple: a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            for p, v in port_paths(tree[k]).items():
                out[f"{k}/{p}" if p else k] = v
        return out
    return {"": tree}


def same_specs(port_tree, ref_tree):
    got, want = port_paths(port_tree), ref_paths(ref_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], PartitionSpec), k
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


RULES = {
    "__sizes__": {"data": 16, "model": 16, "pod": 2},
    "embed": ("data",), "vocab": "model", "mlp": "model", "heads": "model",
    "experts": "model", "ssm_inner": "model", "layers": None, None: None,
}


# -- the twins of tests/test_distributed.py:36-117 -----------------------


def test_spec_basic_tp_fsdp():
    leaf = Leaf((4096, 16384), ("embed", "mlp"))
    assert _spec_for(leaf, RULES) == P("data", "model")


def test_spec_divisibility_fallback():
    # 56-head fused dim 7168 divides; but a 14-dim head axis does not
    leaf = Leaf((14, 64), ("heads", None))
    assert _spec_for(leaf, RULES) == P(None, None)
    leaf2 = Leaf((896, 7168), ("embed", "heads"))
    assert _spec_for(leaf2, RULES) == P("data", "model")


def test_spec_no_duplicate_mesh_axes():
    # expert tensors: experts and mlp both want 'model' -> mlp falls back
    leaf = Leaf((128, 768, 2048), ("experts", "mlp", "embed"))
    spec = _spec_for(leaf, RULES)
    flat = [a for part in spec if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(set(flat))
    assert spec[0] == "model"


@pytest.mark.parametrize("shape,axes", [
    ((4096, 16384), ("embed", "mlp")), ((14, 64), ("heads", None)),
    ((896, 7168), ("embed", "heads")),
    ((128, 768, 2048), ("experts", "mlp", "embed")),
    ((24, 896), ("layers", "embed")), ((7,), (None,)), ((), ()),
    ((48, 2, 8), ("embed", "vocab", "mlp")),
])
def test_spec_for_equals_the_reference(shape, axes):
    for rules in (RULES, dict(RULES, embed=("pod", "data")),
                  dict(RULES, embed=None, experts=("pod", "data"))):
        got = _spec_for(Leaf(shape, axes), rules)
        want = ref_spec_for(RefLeaf(shape, axes), rules)
        assert tuple(got) == tuple(want)


def test_model_specs_cover_every_leaf():
    for arch in ("yi-34b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                 "zamba2-2.7b"):
        cfg = ARCHS[arch]
        specs = tree_paths(model_specs(cfg, RULES))
        abst = tree_paths(abstract_model(cfg))
        assert specs.keys() == abst.keys()   # same structure
        for k, spec in specs.items():
            leaf = abst[k]
            assert len(spec) <= len(leaf.shape)
            for part, dim in zip(spec, leaf.shape):
                if part is None:
                    continue
                axes = part if isinstance(part, tuple) else (part,)
                prod = int(np.prod([RULES["__sizes__"][a] for a in axes]))
                assert dim % prod == 0, (arch, leaf.shape, spec)


def test_batch_spec_fallback():
    mesh = make_production_mesh(multi_pod=True)
    assert batch_spec(mesh, 256, 1) == P(("pod", "data"), None)
    # batch=1 (long_500k): nothing divides -> replicated
    assert batch_spec(mesh, 1, 1) == P(None, None)
    # batch=2: only pod divides
    assert batch_spec(mesh, 2, 1) == P("pod", None)


def test_cache_specs_kv_and_seq_fallback():
    mesh = make_production_mesh()
    cfg = ARCHS["zamba2-2.7b"]          # kv=32 divisible -> heads sharded
    cache = init_cache(cfg, 128, 1024, device="meta")
    found_head_shard = False
    for path, spec in tree_paths(cache_specs(cfg, cache, mesh)).items():
        if path.endswith("/k"):
            assert spec[3] == "model"   # heads sharded
            found_head_shard = True
    assert found_head_shard

    cfg2 = ARCHS["yi-34b"]              # kv=8 not divisible -> seq sharded
    cache2 = init_cache(cfg2, 128, 1024, device="meta")
    for path, spec in tree_paths(cache_specs(cfg2, cache2, mesh)).items():
        if path.endswith("/k"):
            assert spec[2] == "model" and spec[3] is None


# -- the port's own types --------------------------------------------------


def test_meshes():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.size, one.devices) == \
        (("data", "model"), (16, 16), 256, None)
    assert (two.axis_names, two.shape, two.size, two.devices) == \
        (("pod", "data", "model"), (2, 16, 16), 512, None)
    assert mesh_axis_sizes(two) == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes(one) == ("data",) and dp_axes(two) == ("pod", "data")
    host = make_host_mesh("cpu")
    assert (host.shape, host.devices) == ((1, 1), (torch.device("cpu"),))
    assert make_host_mesh("meta").devices == (torch.device("meta"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
    with pytest.raises(ValueError, match="unsupported device"):
        make_host_mesh("mps")


def test_named_sharding_local_shapes():
    mesh = make_production_mesh(multi_pod=True)
    ns = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert ns.local_shape((256, 7, 4096)) == (8, 7, 256)
    assert ns.local_shape((4, 2, 17)) == (1, 2, 2)      # padded up
    assert NamedSharding(mesh, P()).local_shape((5, 3)) == (5, 3)
    host = make_host_mesh("meta")
    assert NamedSharding(host, P("data", "model")).local_shape((9, 9)) == \
        (9, 9)
    tree = param_sharding({"a": P("data"), "b": {"c": P()}}, mesh)
    assert tree == {"a": NamedSharding(mesh, P("data")),
                    "b": {"c": NamedSharding(mesh, P())}}
    assert P("data", None) == RefP("data", None)
    with pytest.raises(ValueError, match="mode"):
        sharding_rules(mesh, mode="infer")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_sharding_rules_equal_the_reference(multi_pod, mode):
    got = sharding_rules(make_production_mesh(multi_pod=multi_pod), mode)
    want = rsh.sharding_rules(ref_mesh(multi_pod), mode)
    assert got == want


# -- leaf for leaf against the reference, all ten archs --------------------


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_specs_equal_the_reference(arch, mesh, mode):
    multi = MESHES[mesh]
    rules = sharding_rules(make_production_mesh(multi_pod=multi), mode)
    ref_rules = rsh.sharding_rules(ref_mesh(multi), mode)
    same_specs(model_specs(ARCHS[arch], rules),
               ref_model_specs(REF_ARCHS[arch], ref_rules))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_model_equals_the_reference(arch):
    for dtype, ref_dtype in ((None, None), (torch.float32, jnp.float32)):
        got = tree_paths(abstract_model(ARCHS[arch]) if dtype is None
                         else abstract_model(ARCHS[arch], dtype))
        want = ref_paths(ref_abstract_model(REF_ARCHS[arch])
                         if ref_dtype is None
                         else ref_abstract_model(REF_ARCHS[arch], ref_dtype))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).replace("torch.", "") == \
                str(want[k].dtype), k


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_specs_equal_the_reference(arch, mesh, quantize):
    multi = MESHES[mesh]
    rules = sharding_rules(make_production_mesh(multi_pod=multi))
    ref_rules = rsh.sharding_rules(ref_mesh(multi))
    pspecs = model_specs(ARCHS[arch], rules)
    params = abstract_model(ARCHS[arch], torch.float32)
    ref_params = ref_abstract_model(REF_ARCHS[arch], jnp.float32)
    got = opt_state_specs(pspecs, AdamWConfig(quantize_moments=quantize),
                          params)
    want = ref_opt_state_specs(
        ref_model_specs(REF_ARCHS[arch], ref_rules),
        RefAdamWConfig(quantize_moments=quantize), ref_params)
    same_specs(got, want)
    # leaf for leaf the layout adamw_init makes, rank for rank
    state = tree_paths(adamw_init(params, AdamWConfig(
        quantize_moments=quantize)))
    specs = tree_paths(got)
    assert state.keys() == specs.keys()
    for k, t in state.items():
        assert len(specs[k]) in (0, t.dim()), k
    ref_state = jax.eval_shape(
        lambda p: ref_adamw_init(p, RefAdamWConfig(
            quantize_moments=quantize)), ref_params)
    assert ref_paths(ref_state).keys() == state.keys()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_spec_equals_the_reference(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for batch in (1, 2, 3, 8, 16, 32, 48, 128, 256, 512, 1024):
        for extra in (0, 1, 2):
            assert tuple(batch_spec(mesh, batch, extra)) == tuple(
                rsh.batch_spec(ref_mesh(multi_pod), batch, extra))


def decode_cells():
    return [(a, s.name) for a in ARCH_NAMES for s in shapes_for(ARCHS[a])
            if s.kind == "decode"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", decode_cells())
def test_cache_specs_equal_the_reference(arch, shape, mesh):
    multi = MESHES[mesh]
    (port_shape,) = [s for s in shapes_for(ARCHS[arch]) if s.name == shape]
    (ref_shape,) = [s for s in ref_shapes_for(REF_ARCHS[arch])
                    if s.name == shape]
    b, s = port_shape.global_batch, port_shape.seq_len
    cache = init_cache(ARCHS[arch], b, s, device="meta")
    ref_cache = jax.eval_shape(lambda: ref_init_cache(
        REF_ARCHS[arch], ref_shape.global_batch, ref_shape.seq_len))
    got = cache_specs(ARCHS[arch], cache,
                      make_production_mesh(multi_pod=multi))
    same_specs(got, rsh.cache_specs(REF_ARCHS[arch], ref_cache,
                                    ref_mesh(multi)))
    # the cache itself, leaf for leaf the reference's shapes and dtypes
    want = ref_paths(ref_cache)
    assert tree_paths(cache).keys() == want.keys()
    for k, t in tree_paths(cache).items():
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_follow_the_reference(arch, mesh):
    """``launch.specs``: the same stand-ins (shape, dtype) and shardings as
    the reference's ``launch/specs.py`` builds (its functions are
    compared through ``batch_spec``, since they need a real mesh)."""
    multi = MESHES[mesh]
    m = make_production_mesh(multi_pod=multi)
    cfg = ARCHS[arch]
    for shape in shapes_for(cfg):
        b, s = shape.global_batch, shape.seq_len
        rb = tuple(rsh.batch_spec(ref_mesh(multi), b, 1))
        if shape.kind == "train":
            batch, sh = train_input_specs(cfg, shape, m)
        elif shape.kind == "prefill":
            batch, sh = prefill_input_specs(cfg, shape, m)
        else:
            (tok, cache, cur), (tok_sh, cache_sh, len_sh) = \
                decode_input_specs(cfg, shape, m)
            assert (tuple(tok.shape), tok.dtype) == ((b, 1), torch.int32)
            assert (tuple(cur.shape), cur.dtype) == ((b,), torch.int32)
            assert tuple(tok_sh.spec) == rb
            assert tuple(len_sh.spec) == tuple(
                rsh.batch_spec(ref_mesh(multi), b, 0))
            specs = tree_paths(cache_specs(cfg, cache, m))
            for k, ns in tree_paths(cache_sh).items():
                assert ns.spec == specs[k] and ns.mesh == m
            continue
        assert tuple(batch["tokens"].shape) == (b, s)
        assert batch["tokens"].dtype == torch.int32
        assert tuple(sh["tokens"].spec) == rb
        if shape.kind == "train":
            assert tuple(sh["labels"].spec) == rb
        if cfg.family in ("vlm", "encdec"):
            n = cfg.n_image_tokens if cfg.family == "vlm" \
                else cfg.n_audio_frames
            assert tuple(batch["aux"].shape) == (b, n, cfg.d_model)
            assert batch["aux"].dtype == torch.bfloat16
            assert tuple(sh["aux"].spec) == tuple(
                rsh.batch_spec(ref_mesh(multi), b, 2))
        else:
            assert "aux" not in batch
