"""The port's launch dry run (``repro_torch.launch.dryrun``): qwen2-0.5b's
full-width ``decode_32k`` cell on meta, the record's fields and memory
against the accounting and the specs, the decode cells whose
``param_mode`` differs from the reference's rule, a meta train step
against a real CPU step, and where the records go
(``$REPRO_CACHE/dryrun_torch/``, never the reference's ``.../dryrun/``,
whose artifact tests would read them).  ``run_cell`` on the smoke configs
of every family is ``tests/test_torch_dryrun_cells.py``.  Meta tensors
hold no storage."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS
from repro.models import shapes_for as ref_shapes_for
from repro.models.accounting import local_param_bytes as ref_local_bytes

import repro_torch.launch.dryrun as dr
from repro_torch.configs import ARCHS
from repro_torch.distributed.sharding import cache_specs, mesh_axis_sizes, \
    param_sharding
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import DECODE_32K, shapes_for, smoke
from repro_torch.models.accounting import local_param_bytes, model_flops
from repro_torch.models.config import ShapeConfig
from repro_torch.training.train_loop import TrainConfig, build_train_step, \
    init_train_state
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.tree import tree_paths

from torch_training_parity import one_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_NAMES = sorted(ARCHS)

#: decode cells whose param_mode is not the reference's rule: both count
#: bf16 params, and the card's 45 GB share replicates llama-3.2-vision
#: (11.3 GB a device), which 9 GiB of a v5e does not (10.6 GiB)
MODE_DIFFERS = [("llama-3.2-vision-90b", "decode_32k", "16x16"),
                ("llama-3.2-vision-90b", "decode_32k", "2x16x16")]

RECORD_KEYS = {"arch", "shape", "kind", "param_mode", "param_dtype", "mesh",
               "n_devices", "seq_len", "global_batch", "trace_seconds",
               "memory", "cost", "model_flops", "tpu_only"}


def expected_decode_flops(cfg, b, s):
    """Every matrix product of a dense decode step, 2·M·N·K each: the four
    projections, the scores and the values over the whole cache, the
    SwiGLU and the unembedding."""
    d, hq, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.d_head, cfg.d_ff)
    layer = (2 * b * d * (hq * dh + 2 * hkv * dh) + 2 * b * hq * dh * d
             + 2 * 2 * b * hq * s * dh + 3 * 2 * b * d * f)
    return cfg.n_layers * layer + 2 * b * d * cfg.vocab_padded


def test_qwen2_full_width_decode_32k_on_meta():
    cfg = ARCHS["qwen2-0.5b"]
    b, s = DECODE_32K.global_batch, DECODE_32K.seq_len
    rec = dr.run_cell("qwen2-0.5b", DECODE_32K, multi_pod=False)
    mesh = make_production_mesh()
    sizes = mesh_axis_sizes(mesh)
    assert rec["param_mode"] == "serve" and rec["param_dtype"] == "bfloat16"
    assert (rec["seq_len"], rec["global_batch"]) == (s, b)
    # every KV leaf [24, 128, 32768, 2, 64] bf16: B over data, the two KV
    # heads do not divide 16, so the sequence over model
    kv_local = 24 * 2 * (b // 16) * (s // 16) * 2 * 64 * 2
    params_local = local_param_bytes(cfg, sizes, mode="serve", dtype_bytes=2)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == \
        params_local + kv_local + 2 * (b // 16) * 4
    assert mem["alias_size_in_bytes"] == kv_local
    logits = b * cfg.vocab_padded * 4            # f32, no sharding given
    assert mem["output_size_in_bytes"] == logits + kv_local
    assert rec["cost"]["flops"] == expected_decode_flops(cfg, b, s)
    assert rec["model_flops"] == model_flops(cfg, DECODE_32K)["model_flops"]
    # on the host mesh every share is the whole tensor: the card's cell
    one = dr.run_cells("qwen2-0.5b", DECODE_32K, [make_host_mesh("meta")])[0]
    n_params = sum(t.numel() for t in tree_paths(
        dr.Cell(cfg, DECODE_32K, make_host_mesh("meta")).args[0]).values())
    assert n_params == 630_396_800
    cache = 24 * 2 * b * s * 2 * 64 * 2
    assert cache == 51_539_607_552
    assert one["memory"]["argument_size_in_bytes"] == \
        2 * n_params + cache + 2 * b * 4
    assert one["mesh"] == "1x1" and one["n_devices"] == 1
    assert one["cost"]["flops"] == rec["cost"]["flops"]


def test_record_names_what_only_a_tpu_compile_gives():
    rec = dr.run_cell("qwen2-0.5b", DECODE_32K, multi_pod=True)
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "alias_size_in_bytes"}
    assert set(rec["cost"]) == {"flops"}
    assert rec["tpu_only"] == [
        "compile_seconds", "memory.temp_size_in_bytes",
        "memory.generated_code_size_in_bytes", "cost (every key but flops)",
        "collectives", "hlo_bytes"]
    for field in ("compile_seconds", "collectives", "hlo_bytes"):
        assert field not in rec
    assert rec["trace_seconds"] > 0


def test_param_mode_differences_from_the_reference():
    """The serve/train choice keeps the reference's rule (replicate when
    the bf16 params fit) with the card's budget, 9/16 of 80 GB; the decode
    cells where that gives another mode than the reference's (9 GiB) are
    exactly ``MODE_DIFFERS``."""
    assert dr.SERVE_PARAM_BYTES == 9 / 16 * 80e9
    differs = []
    for arch in ARCH_NAMES:
        for shape in shapes_for(ARCHS[arch]):
            for multi, name in ((False, "16x16"), (True, "2x16x16")):
                mesh = make_production_mesh(multi_pod=multi)
                got = dr.param_mode(ARCHS[arch], shape, mesh)
                if shape.kind != "decode":
                    assert got == "train"
                    continue
                ref_bytes = ref_local_bytes(REF_ARCHS[arch],
                                            mesh_axis_sizes(mesh),
                                            mode="serve")
                want = "serve" if ref_bytes < 9 * 2**30 else "train"
                if got != want:
                    differs.append((arch, shape.name, name))
    assert differs == MODE_DIFFERS
    assert [s.name for s in ref_shapes_for(REF_ARCHS[
        "llama-3.2-vision-90b"])] == ["train_4k", "prefill_32k",
                                      "decode_32k"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b",
                                  "llama-3.2-vision-90b"])
def test_meta_train_step_equals_a_real_cpu_step_in_shape(arch, one_thread):
    """The dry run's train step on meta tensors gives the outputs of a real
    step on the CPU at smoke size: the same tree, shapes and dtypes, the
    state returned in place, and the same flop count."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = smoke(ARCHS[arch])
    shape = ShapeConfig("train_4k", 64, 4, "train")
    cell = dr.Cell(cfg, shape, make_production_mesh())
    (meta_state, meta_metrics), _, meta_flops = cell.trace()
    assert meta_state is cell.args[0]

    tc = TrainConfig(accum_steps=dr._accum_for(cfg), accum_dtype="bfloat16",
                     opt=AdamWConfig(quantize_moments=True))
    g = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, tc, g, device="cpu", dtype=dr.PARAM_DTYPE)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["aux"] = torch.randn((4, cfg.n_image_tokens, cfg.d_model),
                                   generator=g).to(torch.bfloat16)
    with FlopCounterMode(display=False) as counter:
        real_state, real_metrics = build_train_step(cfg, tc)(state, batch, 0)
    assert real_state is state
    assert counter.get_total_flops() == meta_flops
    got, want = tree_paths(meta_state), tree_paths(real_state)
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
        assert got[k].device.type == "meta"
    for k in ("loss", "lr"):
        assert (meta_metrics[k].shape, meta_metrics[k].dtype) == \
            (real_metrics[k].shape, real_metrics[k].dtype)
    assert torch.isfinite(real_metrics["loss"])
    # the same cell with zero arguments on the CPU: the same outputs' shapes
    cpu = dr.Cell(cfg, shape, make_production_mesh(), device="cpu")
    (cpu_state, _), _, cpu_flops = cpu.trace()
    assert cpu_flops == meta_flops
    assert {k: (t.shape, t.dtype) for k, t in tree_paths(cpu_state).items()} \
        == {k: (t.shape, t.dtype) for k, t in got.items()}


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
def test_alias_bytes_count_only_leaves_updated_in_place(param_dtype,
                                                        monkeypatch):
    """On f32 params a mamba window comes back f32 from a bf16 cache (a
    new tensor, as XLA leaves such a donated buffer unused): the alias
    excludes it.  On bf16 params, the dry run's, the window stays bf16 and
    is updated in place: the alias counts it."""
    monkeypatch.setattr(dr, "PARAM_DTYPE", param_dtype)
    cfg = smoke(ARCHS["falcon-mamba-7b"])
    shape = ShapeConfig("decode_32k", 96, 32, "decode")
    mesh = make_production_mesh()
    cell = dr.Cell(cfg, shape, mesh)
    out, secs, flops = cell.trace()
    rec = cell.record(out, secs, flops)
    cache = cell.args[2]
    sh = param_sharding(cache_specs(cfg, cache, mesh), mesh)
    h_bytes = dr.local_bytes(cache["l0"]["h"], sh["l0"]["h"])
    conv_bytes = dr.local_bytes(cache["l0"]["conv"], sh["l0"]["conv"])
    assert out[1]["l0"]["h"] is cache["l0"]["h"]
    assert cache["l0"]["conv"].dtype == torch.bfloat16
    if param_dtype == torch.float32:
        assert rec["memory"]["alias_size_in_bytes"] == h_bytes
        assert out[1]["l0"]["conv"].dtype == torch.float32
    else:
        assert rec["memory"]["alias_size_in_bytes"] == h_bytes + conv_bytes
        assert out[1]["l0"]["conv"] is cache["l0"]["conv"]


def test_records_go_under_dryrun_torch(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    assert dr.out_dir() == os.path.join(str(tmp_path), "dryrun_torch")
    dr.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"])
    names = sorted(os.listdir(tmp_path / "dryrun_torch"))
    assert names == ["qwen2-0.5b__decode_32k__16x16.json",
                     "qwen2-0.5b__decode_32k__2x16x16.json"]
    assert os.listdir(tmp_path) == ["dryrun_torch"]   # never .../dryrun/
    one = json.load(open(tmp_path / "dryrun_torch" / names[0]))
    two = json.load(open(tmp_path / "dryrun_torch" / names[1]))
    assert (one["mesh"], two["mesh"]) == ("16x16", "2x16x16")
    assert one["cost"] == two["cost"]          # one trace for both meshes
    assert one["trace_seconds"] == two["trace_seconds"]
    capsys.readouterr()
    dr.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
             "--singlepod"])
    out = capsys.readouterr().out
    assert "[skip]" in out and "2x16x16" not in out
    dr.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--multipod",
             "--force"])
    out = capsys.readouterr().out
    assert "[skip]" not in out and "mesh=2x16x16" in out \
        and "mesh=16x16" not in out


def test_cli_with_arch_and_shape(tmp_path):
    env = dict(os.environ, REPRO_CACHE=str(tmp_path),
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "falcon-mamba-7b", "--shape", "long_500k", "--singlepod"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "all requested cells traced" in out.stdout
    rec = json.load(open(
        tmp_path / "dryrun_torch" / "falcon-mamba-7b__long_500k__16x16.json"))
    assert (rec["kind"], rec["global_batch"], rec["seq_len"]) == \
        ("decode", 1, 524288)
    assert not (tmp_path / "dryrun").exists()
    with pytest.raises(KeyError, match="unknown arch"):
        dr.main(["--arch", "no-such-arch"])


def test_the_reference_artifact_directory_is_not_the_ports(monkeypatch):
    """The reference's artifact tests glob ``$REPRO_CACHE/dryrun/*.json``
    and skip while it is empty: the port's directory is another."""
    for cache in (None, "/some/cache"):
        if cache is None:
            monkeypatch.delenv("REPRO_CACHE", raising=False)
        else:
            monkeypatch.setenv("REPRO_CACHE", cache)
        base = cache or ".cache"
        assert dr.out_dir() == os.path.join(base, "dryrun_torch")
        assert dr.out_dir() != os.path.join(base, "dryrun")
