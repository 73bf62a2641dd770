"""``restore_checkpoint(path, template, shardings=...)`` of the port against
the JAX package's, on the CPU.

The port restores a leaf onto the device its sharding's mesh holds, after
the checks ``jax.device_put`` makes of a ``NamedSharding`` (the spec no
longer than the leaf's rank, each sharded dimension divisible by its
axes).  One process holds no global array across cards, so a mesh with no
devices (the production mesh) or over several distinct ones is refused,
naming the mesh (a known difference, ``ROADMAP.md``).  On the host mesh
over the CPU, qwen2-0.5b's params at smoke size restore bit for bit as the
reference's restore puts them on its one CPU device under the same specs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding as RefNamedSharding

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as rsh
from repro.models import config as ref_config
from repro.models import model_specs as ref_model_specs
from repro.training import restore_checkpoint as ref_restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import NamedSharding, P, \
    param_sharding, sharding_rules
from repro_torch.launch.mesh import Mesh, make_host_mesh, \
    make_production_mesh
from repro_torch.models import init_model, model_specs, smoke
from repro_torch.training import restore_checkpoint, save_checkpoint
from repro_torch.training.tree import tree_map, tree_paths

ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """qwen2-0.5b's params at smoke size, saved once by the port."""
    cfg = smoke(get_config(ARCH))
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    path = save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), 5, params,
                           extra={"arch": ARCH})
    return cfg, params, path


def host_shardings(cfg, device="cpu"):
    mesh = make_host_mesh(device)
    return param_sharding(model_specs(cfg, sharding_rules(mesh)), mesh)


def test_restore_with_shardings_equals_the_references(saved):
    cfg, params, path = saved
    got, step, extra = restore_checkpoint(path, params,
                                          shardings=host_shardings(cfg))
    assert (step, extra) == (5, {"arch": ARCH})
    ref_cfg = ref_config.smoke(REF_ARCHS[ARCH])
    mesh = RefMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))
    specs = ref_model_specs(ref_cfg, rsh.sharding_rules(mesh))
    ref_sh = jax.tree_util.tree_map(
        lambda s: RefNamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    template = tree_map(lambda t: t.numpy(), params)
    want, ref_step, _ = ref_restore_checkpoint(path, template,
                                               shardings=ref_sh)
    assert ref_step == step
    got_p = tree_paths(got)
    want_p = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got_p.keys() == want_p.keys()
    for k, leaf in got_p.items():
        assert leaf.device.type == "cpu"
        w = np.asarray(want_p[k])
        assert leaf.dtype == torch.float32 and w.dtype == np.float32
        assert np.array_equal(leaf.numpy().view(np.int32),
                              w.view(np.int32)), k


def test_restore_with_shardings_equals_the_plain_restore(saved):
    cfg, params, path = saved
    plain, _, _ = restore_checkpoint(path, params)
    meta = tree_map(lambda t: t.to("meta"), params)
    got, _, _ = restore_checkpoint(path, meta, shardings=host_shardings(cfg))
    for k, leaf in tree_paths(got).items():
        assert leaf.device.type == "cpu", k
        assert torch.equal(leaf.view(torch.int32),
                           tree_paths(plain)[k].view(torch.int32)), k
    # a single leaf with a single sharding
    w = params["embed"]["embedding"]
    path1 = save_checkpoint(path + "_one", 1, w)
    one, _, _ = restore_checkpoint(
        path1, w, shardings=NamedSharding(make_host_mesh("cpu"), P()))
    assert torch.equal(one, w)


def test_refused_shardings_raise(saved):
    cfg, params, path = saved
    prod = make_production_mesh()
    with pytest.raises(ValueError, match="holds no devices"):
        restore_checkpoint(path, params, shardings=param_sharding(
            model_specs(cfg, sharding_rules(prod)), prod))
    two = Mesh(("data", "model"), (2, 1), ("cpu", "meta"))
    with pytest.raises(ValueError, match="spans 2 devices"):
        restore_checkpoint(path, params, shardings=tree_map(
            lambda _: NamedSharding(two, P()), params))
    one = make_host_mesh("cpu")
    rank = tree_map(
        lambda t: NamedSharding(one, P(*([None] * (t.ndim + 1)))), params)
    with pytest.raises(ValueError, match="entries for a leaf of rank"):
        restore_checkpoint(path, params, shardings=rank)
    odd = Mesh(("data", "model"), (3, 1), ("cpu",))
    with pytest.raises(ValueError, match="does not divide"):
        restore_checkpoint(path, params, shardings=tree_map(
            lambda t: NamedSharding(odd, P("data")), params))
    shardings = host_shardings(cfg)
    shardings.pop("final_norm")
    with pytest.raises(ValueError, match="template's structure"):
        restore_checkpoint(path, params, shardings=shardings)
    with pytest.raises(ValueError, match="not a NamedSharding"):
        restore_checkpoint(path, params, shardings=tree_map(
            lambda t: P(), params))
