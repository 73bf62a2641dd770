"""The port's gradient compression (``repro_torch.distributed.compression``)
against the JAX package's, on the CPU.

- the mirrors of ``tests/test_distributed.py``'s two compression tests;
- codes and scales bit for bit the reference's on the same f32 inputs
  (both round half to even), with a zero row, rows of exact .5 ties, 1-D,
  2-D and 3-D leaves; dequantized values and ``ef_compress``'s residuals
  over several steps likewise;
- ``psum_compressed`` on 1, 2 and 4 shards against the reference's under
  ``shard_map`` on forced host devices (a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), the port's
  result bit-stable from run to run and replicated on every shard.
  ``shard_map`` run op by op (as the reference's own compression tests run
  its functions): exact at D <= 2, where a sum of two is the same in any
  order; at D = 4 within C5's rtol 1e-5 / atol 1e-6, since the port adds
  the shards in shard order and XLA's all-reduce in its own.  Under
  ``jax.jit`` XLA's simplifier turns the division of the row's absmax by
  the constant 127 into a product with the f32 reciprocal of 127, so a
  compiled reference's scale can differ from the division's in its last
  bit, and every element of that row with it: held to C5's tolerance at
  every D.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.distributed import dequantize_tree as ref_dequantize_tree
from repro.distributed import ef_compress as ref_ef_compress
from repro.distributed import quantize_tree as ref_quantize_tree
from repro_torch.distributed import dequantize_tree, ef_compress, \
    psum_compressed, quantize_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6     # C5's: the reduction orders differ on reals
SHARDS = (1, 2, 4)


def ties_tree():
    """f32 leaves: normal rows, a zero row, rows whose absmax is 127 so that
    the scale is 1 and x / scale hits exact .5 ties, a 1-D and a 3-D leaf."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(6, 33)) * 3).astype(np.float32)
    w[2] = 0.0
    w[3, :8] = [127, -127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    w[3, 8:] = rng.integers(-120, 120, 25) + 0.5
    w[4, :4] = [-127, 126.5, -126.5, 3.5]
    return {"w": w,
            "b": rng.normal(size=(7,)).astype(np.float32),
            "e": {"t": (rng.normal(size=(3, 4, 9)) * 1e-3).astype(
                np.float32)}}


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def flat(tree, prefix=""):
    """``{path: numpy array}`` of a port or reference tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_bits(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        assert np.array_equal(g[k].view(np.uint8), w[k].view(np.uint8)), k


# -- the twins of tests/test_distributed.py:119-152 -------------------------


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    tree = {"w": torch.tensor(rng.normal(size=(64, 128)) * 3,
                              dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=(7,)), dtype=torch.float32)}
    deq = dequantize_tree(quantize_tree(tree))
    err = (deq["w"] - tree["w"]).abs().max()
    scale = tree["w"].abs().amax(dim=-1).max() / 127
    assert float(err) <= float(scale) + 1e-6
    assert torch.equal(deq["b"], tree["b"])   # 1-D passthrough
    assert deq["b"] is tree["b"]


def test_error_feedback_accumulates_to_truth():
    """Sum of EF-compressed grads converges to sum of true grads."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros((16, 32))
    comp_sum = np.zeros((16, 32))
    residual = None
    for _ in range(50):
        g = {"w": torch.tensor(rng.normal(size=(16, 32)) * 0.1,
                               dtype=torch.float32)}
        true_sum += g["w"].numpy()
        comp, residual = ef_compress(g, residual)
        comp_sum += dequantize_tree(comp)["w"].numpy()
    gap = np.abs(true_sum - comp_sum).max()
    res = np.abs(residual["w"].numpy()).max()
    assert gap <= res + 1e-5
    assert gap < 0.05 * np.abs(true_sum).max() + 0.1


# -- bit for bit against the reference --------------------------------------


def test_codes_and_scales_equal_the_references():
    tree = ties_tree()
    got = quantize_tree(to_port(tree))
    want = ref_quantize_tree({k: (jnp.asarray(v) if not isinstance(v, dict)
                                  else {"t": jnp.asarray(v["t"])})
                              for k, v in tree.items()})
    assert_bits(got, want)
    assert got["w"]["q"].dtype == torch.int8
    assert got["w"]["scale"].shape == (6, 1)
    assert got["w"]["q"][2].abs().sum() == 0           # the zero row
    # the ties round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert got["w"]["q"][3, :8].tolist() == [127, -127, 0, 2, 2, 0, -2, -2]
    assert_bits(dequantize_tree(got), ref_dequantize_tree(want))


def test_ef_compress_steps_equal_the_references():
    rng = np.random.default_rng(2)
    residual = ref_residual = None
    for _ in range(4):
        g = {"w": (rng.normal(size=(8, 40)) * 0.1).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        comp, residual = ef_compress(to_port(g), residual)
        ref_comp, ref_residual = ref_ef_compress(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_residual)
        assert_bits(comp, ref_comp)
        assert_bits(residual, ref_residual)


# -- psum_compressed against the reference's under shard_map ----------------


_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed import psum_compressed

    assert len(jax.devices()) == 4, jax.devices()
    data = np.load(sys.argv[1])
    out = {}
    for d in (1, 2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:d]), ("d",))
        tree = {k: jnp.asarray(data[f"{k}{d}"]) for k in ("w", "b", "t")}
        fn = shard_map(lambda g: psum_compressed(g, "d"), mesh=mesh,
                       in_specs=P("d"), out_specs=P(), check_rep=False)
        for mode, run in (("eager", fn), ("jit", jax.jit(fn))):
            out[f"{mode}{d}"] = {k: np.asarray(v).tolist()
                                 for k, v in run(tree).items()}
    print(json.dumps(out))
""")


def shard_inputs(d, seed=3):
    """D shards' trees (the reference's input is each leaf's shards
    concatenated on axis 0): a [6, 40] leaf with a zero row, a [5] leaf,
    a [2, 3, 16] leaf."""
    rng = np.random.default_rng(seed + d)
    shards = []
    for _ in range(d):
        w = rng.normal(size=(6, 40)).astype(np.float32)
        w[1] = 0.0
        shards.append({"w": w,
                       "b": rng.normal(size=(5,)).astype(np.float32),
                       "t": (rng.normal(size=(2, 3, 16)) * 50).astype(
                           np.float32)})
    return shards


@pytest.fixture(scope="module")
def reference_psum(tmp_path_factory):
    """One run of the reference's ``psum_compressed`` on 1, 2 and 4 forced
    host devices."""
    path = tmp_path_factory.mktemp("psum") / "inputs.npz"
    arrays = {}
    for d in SHARDS:
        for k in ("w", "b", "t"):
            arrays[f"{k}{d}"] = np.concatenate(
                [s[k] for s in shard_inputs(d)], axis=0)
    np.savez(path, **arrays)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("d", SHARDS)
def test_psum_compressed_equals_the_references(reference_psum, d):
    shards = [to_port(s) for s in shard_inputs(d)]
    got = psum_compressed(shards, ["cpu"] * d)
    again = psum_compressed(shards, ["cpu"] * d)
    assert len(got) == d
    for tree in got[1:] + again:
        assert_bits(tree, got[0])                   # replicated, bit-stable
    for mode in ("eager", "jit"):
        want = reference_psum[f"{mode}{d}"]
        for k in ("w", "b", "t"):
            ref = np.asarray(want[k], np.float32).reshape(got[0][k].shape)
            if mode == "eager" and d <= 2:
                assert np.array_equal(got[0][k].numpy(), ref), k
            else:
                np.testing.assert_allclose(got[0][k].numpy(), ref,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{mode} {k}")


def test_psum_compressed_is_the_shard_ordered_mean_of_dequantized_shards():
    shards = [to_port(s) for s in shard_inputs(4)]
    got = psum_compressed(shards, ["cpu"] * 4)[0]
    deq = [dequantize_tree(quantize_tree(s)) for s in shards]
    for k in ("w", "b", "t"):
        total = deq[0][k]
        for part in deq[1:]:
            total = total + part[k]
        assert torch.equal(got[k], total / 4), k
    with pytest.raises(ValueError, match="shard trees"):
        psum_compressed(shards, ["cpu"] * 3)
