"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) against
the JAX package's, on the CPU.

- the mirror of ``tests/test_distributed.py::
  test_pipeline_single_stage_identity``;
- 2 and 4 stages against the reference's ``pipelined_apply`` on forced host
  devices (a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on a toy
  ``stage_fn`` (rtol / atol 1e-5) and on qwen2-0.5b's ``stage_forward`` at
  smoke size (4 reps; the reference's draw, well scaled, carried across by
  ``convert.model_params_from_reference``; C9: 1e-5 normwise), with
  ``n_micro`` 1 (the toy), fewer microbatches than stages, and more;
- pipelined equals unpipelined in the port, bit for bit: the same ops in
  the same order on one device (the port skips the bubbles the reference
  masks);
- a stage axis that does not divide the reps raises, and so do stage
  params that do not lead with the pipeline's stage count.

Every stage runs on the CPU: a mesh over one device puts every stage there.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as RefMesh

from repro.distributed.pipeline import pipelined_apply as ref_pipelined_apply
from repro_torch.convert import model_params_from_reference
from repro_torch.distributed.pipeline import axis_devices, \
    pipeline_forward, pipelined_apply, stage_params_of
from repro_torch.launch.dryrun import pipeline_stage_fn
from repro_torch.launch.mesh import Mesh, make_production_mesh
from torch_training_parity import family_model, normwise
from torch_training_parity import one_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_TOL = 1e-5
MODEL_TOL = 1e-5        # C9: whole models are held normwise
#: (stages, microbatches): n_micro 1, fewer microbatches than stages, more
CASES = ((2, 1), (2, 3), (4, 2), (4, 5))
#: the model's cases against the reference (each compiles the model anew)
MODEL_CASES = ((2, 3), (4, 2))


def toy_fn(p, x):
    return torch.tanh(x @ p["w"])


def toy_inputs(n_stages, n_micro, seed=0):
    rng = np.random.default_rng(seed + 10 * n_stages + n_micro)
    w = (rng.normal(size=(n_stages, 8, 8)) / 3).astype(np.float32)
    x = rng.normal(size=(n_micro, 4, 8)).astype(np.float32)
    return w, x


def model_inputs(n_micro, seed=0):
    cfg, _, tree = family_model("qwen2-0.5b", seed)
    x = np.random.default_rng(seed + n_micro).normal(
        size=(n_micro, 2, 16, cfg.d_model)).astype(np.float32)
    return cfg, tree["blocks"], x


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def cpu_pipe(n_stages):
    return Mesh(("pod",), (n_stages,), ("cpu",))


# -- the mirror of tests/test_distributed.py:154 ----------------------------


def test_pipeline_single_stage_identity():
    w = torch.tensor(np.random.default_rng(0).normal(size=(8, 8)),
                     dtype=torch.float32)
    stage_params = {"w": w[None]}  # [n_stages=1, 8, 8]
    x_micro = torch.tensor(np.random.default_rng(1).normal(size=(3, 4, 8)),
                           dtype=torch.float32)
    got = pipelined_apply(cpu_pipe(1), toy_fn, stage_params, x_micro,
                          axis="pod")
    ref = torch.stack([toy_fn({"w": w}, x_micro[i]) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    # and the reference's own single-stage run on its one device
    want = ref_pipelined_apply(
        RefMesh(np.asarray(jax.devices()[:1]), ("pod",)),
        lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(w.numpy())[None]},
        jnp.asarray(x_micro.numpy()), axis="pod")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOY_TOL, atol=TOY_TOL)


# -- against the reference's pipelined_apply on 2 and 4 devices -------------


_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import ARCHS
    from repro.distributed.pipeline import pipelined_apply
    from repro.models import config
    from repro.models.blocks import stage_forward, superblock_table

    assert len(jax.devices()) == 4, jax.devices()
    data = dict(np.load(sys.argv[1]))
    cfg = config.smoke(ARCHS["qwen2-0.5b"])
    _, kinds, _, _ = superblock_table(cfg)

    def model_fn(p, x):
        return stage_forward(p, None, cfg, kinds, x)[0]

    def toy_fn(p, x):
        return jnp.tanh(x @ p["w"])

    out = {}
    for key in sorted(k for k in data if k.startswith("case/")):
        _, kind, s, m = key.split("/")[:4]
        if not key.endswith("/x"):
            continue
        s = int(s)
        mesh = Mesh(np.asarray(jax.devices()[:s]), ("pod",))
        prefix = key[:-2]
        if kind == "toy":
            params = {"w": jnp.asarray(data[prefix + "/w"])}
            fn = toy_fn
        else:
            params = {}
            for k, v in data.items():
                if k.startswith("blocks/"):
                    node = params
                    parts = k.split("/")[1:]
                    for p in parts[:-1]:
                        node = node.setdefault(p, {})
                    node[parts[-1]] = jnp.asarray(
                        v.reshape((s, v.shape[0] // s) + v.shape[1:]))
            fn = model_fn
        out[prefix] = np.asarray(pipelined_apply(
            mesh, fn, params, jnp.asarray(data[key]), axis="pod"))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """One run of the reference's pipeline on 2 and 4 forced host devices
    for every case: {case: outputs}."""
    tmp = tmp_path_factory.mktemp("pipeline")
    data = {}
    for s, m in CASES:
        w, x = toy_inputs(s, m)
        data[f"case/toy/{s}/{m}/w"] = w
        data[f"case/toy/{s}/{m}/x"] = x
    for s, m in MODEL_CASES:
        _, blocks, x = model_inputs(m)
        data[f"case/model/{s}/{m}/x"] = x
    for k, v in flat(blocks).items():
        data[f"blocks/{k}"] = v
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("n_stages,n_micro", CASES)
def test_toy_pipeline_equals_the_references(reference_runs, n_stages,
                                            n_micro):
    w, x = toy_inputs(n_stages, n_micro)
    got = pipelined_apply(cpu_pipe(n_stages), toy_fn,
                          {"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(
        got.numpy(), reference_runs[f"case/toy/{n_stages}/{n_micro}"],
        rtol=TOY_TOL, atol=TOY_TOL)


@pytest.mark.parametrize("n_stages,n_micro", MODEL_CASES)
def test_model_pipeline_equals_the_references(reference_runs, one_thread,
                                              n_stages, n_micro):
    cfg, blocks, x = model_inputs(n_micro)
    staged = stage_params_of(model_params_from_reference(blocks, "cpu"),
                             n_stages)
    with torch.no_grad():
        got = pipelined_apply(cpu_pipe(n_stages), pipeline_stage_fn(cfg),
                              staged, torch.from_numpy(x))
    want = reference_runs[f"case/model/{n_stages}/{n_micro}"]
    assert got.shape == want.shape
    assert normwise(got.numpy(), want) < MODEL_TOL


# -- the port against itself ------------------------------------------------


@pytest.mark.parametrize("n_stages,n_micro", ((1, 3),) + CASES)
def test_pipelined_equals_unpipelined_bit_for_bit(one_thread, n_stages,
                                                  n_micro):
    cfg, blocks, x = model_inputs(n_micro)
    params = model_params_from_reference(blocks, "cpu")
    fn = pipeline_stage_fn(cfg)
    x_micro = torch.from_numpy(x)
    with torch.no_grad(), make_production_mesh() as ctx:
        got = pipelined_apply(cpu_pipe(n_stages), fn,
                              stage_params_of(params, n_stages), x_micro)
        want = torch.stack([fn(params, x_micro[i]) for i in range(n_micro)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # hints record outside the stages (the unpipelined stack), never inside
    stack_hints = len(ctx.hints)
    assert stack_hints == n_micro * 4 * 7
    with torch.no_grad(), make_production_mesh() as ctx:
        pipelined_apply(cpu_pipe(n_stages), fn,
                        stage_params_of(params, n_stages), x_micro)
    assert ctx.hints == []


def test_stage_params_are_views_moved_once():
    stacked = {"a": torch.arange(24.0).reshape(6, 4),
               "b": {"c": torch.zeros(6, 2, 3)}}
    staged = stage_params_of(stacked, 3)
    assert staged["a"].shape == (3, 2, 4)
    assert staged["b"]["c"].shape == (3, 2, 2, 3)
    assert staged["a"].data_ptr() == stacked["a"].data_ptr()
    seen = []

    def fn(p, x):
        seen.append(p["a"].data_ptr())
        return x + p["a"].sum()

    x = torch.zeros(4, 1)
    out = pipeline_forward(fn, 3)(staged, x)
    assert out.shape == x.shape
    # each stage's slice is the same view at every tick: moved once
    assert len(seen) == 3 * 4 and len(set(seen)) == 3


def test_bad_stage_axes_raise():
    stacked = {"w": torch.zeros(6, 2, 2)}
    with pytest.raises(ValueError, match="4 stages do not divide"):
        stage_params_of(stacked, 4)
    with pytest.raises(ValueError, match="lead with 3 stages"):
        pipelined_apply(cpu_pipe(2), toy_fn, stage_params_of(stacked, 3),
                        torch.zeros(2, 2, 2))


def test_axis_devices():
    assert axis_devices(cpu_pipe(4), "pod") == [torch.device("cpu")] * 4
    assert axis_devices(make_production_mesh(multi_pod=True), "pod") \
        == [torch.device("meta")] * 2
    mesh = Mesh(("pod", "data"), (2, 2), ("cpu", "meta", "meta", "cpu"))
    assert axis_devices(mesh, "pod") == [torch.device("cpu"),
                                         torch.device("meta")]
    assert axis_devices(mesh, "data") == axis_devices(mesh, "pod")
