"""Rules the port keeps: it imports neither JAX nor the JAX package, runs
on the card unless the caller asks for the CPU, and never falls back from a
kernel to its plain version."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for f in ("torch_table1.py", "torch_calibrate_profile.py"):
        yield os.path.join(REPO, "benchmarks", f)
    examples = os.path.join(REPO, "examples")
    for f in sorted(os.listdir(examples)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(examples, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.sparse, repro_torch.models, "
            "repro_torch.configs, repro_torch.serving, "
            "repro_torch.distributed\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", [
    "repro_torch.models.accounting", "repro_torch.distributed.sharding",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.dryrun", "repro_torch.distributed.hints",
    "repro_torch.distributed.pipeline",
    "repro_torch.distributed.compression"])
def test_the_launch_modules_load_no_jax(module):
    """The dry run and the modules it calls import neither JAX nor the JAX
    package (the reference's dry run sets ``XLA_FLAGS`` at import; the
    port's sets nothing), and the production mesh holds no device."""
    code = (f"import os, sys, {module}\n"
            "from repro_torch.launch.mesh import make_production_mesh\n"
            "assert make_production_mesh(multi_pod=True).devices is None\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad, 'XLA_FLAGS' in os.environ)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[] False"

def test_spgemm_without_device_needs_a_card():
    """device=None means the card: with none present it raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    from repro_torch.core import cached_plan, spgemm
    from repro_torch.sparse import random_uniform_csc

    a = random_uniform_csc(16, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cached_plan(a, a)


def test_spgemm_batched_without_device_needs_a_card():
    """The batched entry point runs on the card by default too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    from repro_torch.core import spgemm_batched
    from repro_torch.sparse import BatchedCSC, random_uniform_csc

    a = random_uniform_csc(16, 2, seed=0)
    s = BatchedCSC.from_values(a, torch.ones((2, a.nnz)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm_batched(s, s)


@pytest.mark.parametrize("kernel", ["spa", "spars", "hash", "fused",
                                    "spa_batched", "spars_batched",
                                    "hash_batched", "fused_batched", "bsr",
                                    "bsr_batched"])
def test_cpu_tensor_with_cuda_device_raises(kernel):
    """A kernel entry asked to run on the card never runs a CPU tensor
    through the plain version instead."""
    from repro_torch import kernels

    z = torch.zeros((16, 2), dtype=torch.int32)
    v = torch.zeros((16, 2), dtype=torch.float32)
    n = torch.zeros(16, dtype=torch.int32)
    steps = torch.zeros(1, dtype=torch.int32)
    if kernel.endswith("_batched"):
        v = v[None]
    name = kernel.split("_")[0]
    fn = getattr(kernels, ("fused_stream" if name == "fused"
                           else "bsr_spmm" if name == "bsr"
                           else f"{name}_spgemm")
                 + ("_batched" if kernel.endswith("_batched") else ""))
    with pytest.raises(ValueError, match="device"):
        if name == "spa":
            fn(z, v, n, z, v, n, m=16, block_cols=16, device="cuda")
        elif name == "bsr":
            blocks = torch.zeros((16, 2, 8, 8))
            fn(z, n, blocks, torch.zeros(v.shape[:-1] + (8,)), bn=8,
               device="cuda")
        elif name == "fused":
            x = v[..., 0].contiguous()
            fn(n, n, n[:2], x, x, device="cuda")
        elif name == "spars":
            fn(z, v, n, z, v, n, steps, m=16, block_cols=16, device="cuda")
        else:
            fn(z, v, n, z, v, n, steps, m=16, h=4, block_cols=16,
               device="cuda")


def test_no_fallback_in_wrappers():
    """No wrapper catches its kernel's failure: the kernel modules, the
    stream engines (fused, torch, mesh and host), the host oracles and the
    sparse FFN hold no ``try`` at all (their locks are ``with`` blocks), and
    chip_smoke.py catches no phase failure."""
    for f in ("kernels/spa.py", "kernels/spars.py", "kernels/hash_spgemm.py",
              "kernels/fused_stream.py", "kernels/bsr_spmm.py",
              "kernels/ops.py", "core/fused_stream.py",
              "core/device_stream.py", "core/naive.py", "core/fast.py",
              "distributed/spgemm_mesh.py", "models/sparse_ffn.py"):
        tree = ast.parse(open(os.path.join(PORT, f)).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), f
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of leaving a wrapper
    to fall back."""
    import torch.utils.cpp_extension as cpp_ext

    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    """K2 and K3 share ``csrc/slice_kernel.cuh``: an edit to it changes the
    library's cache key, so the kernels are built again; only the ``.cu``
    files are compiled."""
    from repro_torch.kernels import _build

    for f in _build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    key = _build._key()
    header = tmp_path / "slice_kernel.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._key() != key
    assert {p.suffix for p in _build.sources()} == {".cu"}


def test_profile_catches_only_file_and_json_errors():
    """``core/profile.py`` catches no ``Exception``: a calibration on the
    card that fails reaches the caller.  Its only handlers name the errors
    of reading a file or parsing JSON (``json.JSONDecodeError`` is a
    ``ValueError``) and of asking the OS for its memory size."""
    allowed = {"OSError", "ValueError", "KeyError", "TypeError"}
    tree = ast.parse(open(os.path.join(PORT, "core", "profile.py")).read())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers
    for h in handlers:
        assert h.type is not None, f"bare except at line {h.lineno}"
        names = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        caught = {n.id for n in names if isinstance(n, ast.Name)}
        assert len(caught) == len(names) and caught <= allowed, \
            f"line {h.lineno} catches {ast.unparse(h.type)}"


def _handlers(path):
    """Each ``try`` of ``path`` as (enclosing function, caught names,
    has a ``finally``)."""
    tree = ast.parse(open(path).read())
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Try):
                caught = tuple(sorted(
                    ast.unparse(h.type) if h.type is not None else "*"
                    for h in child.handlers))
                out.append((fn, caught, bool(child.finalbody)))
            visit(child, fn)

    visit(tree, None)
    return sorted(out)


# where the resilience modules may catch: where the reference catches
RESILIENCE_TRIES = {
    "core/faults.py": [("inject", (), True)],
    "core/api.py": [("get_or_build", (), True), ("resize", ("Exception",),
                                                False)],
    "core/plan_builder.py": [("_run_task", ("BaseException",), False),
                             ("_watchdog", ("ValueError",), False),
                             ("poll", ("queue.Empty",), False),
                             ("rewarm", ("RuntimeError",), False)],
    "serving/engine.py": [("_warm_task", ("BaseException",), False)],
    "serving/resilience.py": [],
}


@pytest.mark.parametrize("module", sorted(RESILIENCE_TRIES))
def test_resilience_modules_catch_only_where_the_reference_does(module):
    """The fault, builder, breaker and engine modules catch only where the
    reference's do: the injection context's ``finally``, the single-flight
    ``finally``, the eviction listeners, the builder's worker (its failure
    goes to ``poll()``), retry, watchdog and the drain of its completion
    queue, and the engine's warm task,
    which reports to the breaker and re-raises.  The reference's module
    holds the same handlers."""
    assert _handlers(os.path.join(PORT, module)) == RESILIENCE_TRIES[module]
    ref = os.path.join(REPO, "src", "repro", module)
    ref_caught = sorted(c for _, c, _ in _handlers(ref))
    assert ref_caught == sorted(c for _, c, _ in RESILIENCE_TRIES[module])
    if module == "serving/engine.py":
        tree = ast.parse(open(os.path.join(PORT, module)).read())
        (warm,) = [n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "_warm_task"]
        (handler,) = [h for n in ast.walk(warm) if isinstance(n, ast.Try)
                      for h in n.handlers]
        last = handler.body[-1]
        assert isinstance(last, ast.Raise) and last.exc is None
