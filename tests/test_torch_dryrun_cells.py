"""The dry run (``repro_torch.launch.dryrun``) on the smoke configs of
every family, every (architecture x shape) cell of ``shapes_for`` at a
smoke size, on the 16x16 and 2x16x16 meshes from one trace (``run_cells``,
which ``run_cell`` and the CLI call): the record's fields, memory and
flops; and ``run_cell`` on a train cell with the reference's gradient
accumulation.
Meta tensors hold no storage; each trace takes about a second."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import repro_torch.launch.dryrun as dr
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import shapes_for, smoke
from repro_torch.models.accounting import model_flops
from repro_torch.models.config import ShapeConfig

from torch_training_parity import one_thread  # noqa: F401  (fixture)

ARCH_NAMES = sorted(ARCHS)
RECORD_KEYS = {"arch", "shape", "kind", "param_mode", "param_dtype", "mesh",
               "n_devices", "seq_len", "global_batch", "trace_seconds",
               "memory", "cost", "model_flops", "tpu_only"}


@pytest.fixture
def smoke_configs(monkeypatch):
    monkeypatch.setattr(dr, "get_config", lambda arch: smoke(ARCHS[arch]))


def small(shape: ShapeConfig) -> ShapeConfig:
    """The cell's kind and name at a smoke size (one attention chunk of a
    smoke config, B divisible by the DP axes or not)."""
    seq = {"train": 32, "prefill": 128, "decode": 96}[shape.kind]
    batch = {"train": 2, "prefill": 2, "decode": 32}[shape.kind]
    if shape.name == "long_500k":
        seq, batch = 256, 1
    return dataclasses.replace(shape, seq_len=seq, global_batch=batch)


def smoke_cells():
    return [(a, s.name) for a in ARCH_NAMES for s in shapes_for(ARCHS[a])]


@pytest.mark.parametrize("arch,shape", smoke_cells())
def test_run_cell_on_smoke_configs(arch, shape, smoke_configs, one_thread):
    (full,) = [s for s in shapes_for(ARCHS[arch]) if s.name == shape]
    cell_shape = small(full)
    cfg = smoke(ARCHS[arch])
    recs = dr.run_cells(arch, cell_shape, [
        make_production_mesh(multi_pod=False),
        make_production_mesh(multi_pod=True)])
    assert recs[0]["cost"] == recs[1]["cost"]   # one trace, two records
    for multi, rec in zip((False, True), recs):
        assert set(rec) == RECORD_KEYS | (
            {"accum_steps"} if full.kind == "train" else set())
        assert (rec["arch"], rec["shape"], rec["kind"]) == \
            (cfg.name, shape, full.kind)
        assert rec["mesh"] == ("2x16x16" if multi else "16x16")
        assert rec["n_devices"] == (512 if multi else 256)
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["output_size_in_bytes"] > 0
        if full.kind == "prefill":
            assert mem["alias_size_in_bytes"] == 0
        else:
            assert 0 < mem["alias_size_in_bytes"] <= \
                mem["output_size_in_bytes"]
        assert rec["cost"]["flops"] > 0
        assert rec["model_flops"] == model_flops(cfg, cell_shape)[
            "model_flops"]
        json.dumps(rec)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "seamless-m4t-large-v2"])
def test_train_cell_with_accumulation(arch, smoke_configs, one_thread,
                                      monkeypatch):
    """The reference's accum_steps > 1 with a bf16 buffer and 8-bit moments
    (smoke configs would take 1): the optimizer state aliases in place."""
    monkeypatch.setattr(dr, "_accum_for", lambda cfg: 2)
    shape = ShapeConfig("train_4k", 32, 4, "train")
    rec = dr.run_cell(arch, shape, multi_pod=False)
    assert rec["accum_steps"] == 2
    cell = dr.Cell(smoke(ARCHS[arch]), shape, make_production_mesh())
    state_bytes = dr.local_bytes(cell.args[0], cell.shardings[0])
    assert rec["memory"]["alias_size_in_bytes"] == state_bytes
    assert rec["memory"]["output_size_in_bytes"] == state_bytes + 8
