"""The port's dry run of the reference's pipeline cell
(``repro_torch.launch.dryrun.run_pipeline_check``, ``--pipeline``) at the
reference's shape: qwen2-0.5b's 24 reps in 2 stages over ``pod`` of the
2x16x16 mesh, 4 microbatches of [8, 4096], traced on meta.

Its flops equal, exactly, those of the unpipelined stack on the same
4 x 8 x 4096 tokens (the port skips the bubbles; a microbatch's flops do
not depend on the others', so the stack is traced on one microbatch and
counted 4 times); its argument bytes are the spec arithmetic: the staged
params split over ``pod``, the microbatches replicated; its output is the
microbatches' shape, replicated.  ``--pipeline`` writes the record to
``$REPRO_CACHE/dryrun_torch/pipeline_pp2.json``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode

import repro_torch.launch.dryrun as dr
from repro_torch.configs import get_config
from repro_torch.models import abstract_model
from repro_torch.training.tree import tree_leaves

from torch_training_parity import one_thread  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield dr.run_pipeline_check()
    finally:
        torch.set_num_threads(n)


def test_pipeline_record_at_the_references_shape(record, one_thread):
    cfg = get_config(dr.PIPELINE_ARCH)
    assert (dr.PIPELINE_STAGES, dr.PIPELINE_MICRO, dr.PIPELINE_BM,
            dr.PIPELINE_SEQ) == (2, 4, 8, 4096)
    assert {k: record[k] for k in ("arch", "shape", "kind", "mesh",
                                   "param_dtype")} == {
        "arch": "qwen2-0.5b", "shape": "pipeline_pp2", "kind": "pipeline",
        "mesh": "2x16x16", "param_dtype": "bfloat16"}
    assert set(record) == {"arch", "shape", "kind", "mesh", "param_dtype",
                           "trace_seconds", "memory", "cost", "tpu_only"}
    assert "collectives" in record["tpu_only"]
    assert "compile_seconds" in record["tpu_only"]

    blocks = abstract_model(cfg, dr.PARAM_DTYPE)["blocks"]
    x = torch.empty((dr.PIPELINE_BM, dr.PIPELINE_SEQ, cfg.d_model),
                    dtype=dr.PARAM_DTYPE, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        dr.pipeline_stage_fn(cfg)(blocks, x)
    assert record["cost"]["flops"] == \
        dr.PIPELINE_MICRO * counter.get_total_flops() > 0

    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(blocks))
    x_bytes = dr.PIPELINE_MICRO * x.numel() * x.element_size()
    assert record["memory"] == {
        "argument_size_in_bytes": param_bytes // dr.PIPELINE_STAGES
        + x_bytes,
        "output_size_in_bytes": x_bytes,
        "alias_size_in_bytes": 0}


def test_the_cli_writes_the_pipeline_record(record, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    monkeypatch.setattr(dr, "run_pipeline_check", lambda: record)
    dr.main(["--pipeline"])
    path = tmp_path / "dryrun_torch" / "pipeline_pp2.json"
    assert json.loads(path.read_text()) == record
    assert not (tmp_path / "dryrun").exists()
