"""Dry run: size every (architecture x input shape x mesh) cell without
running it on the mesh.

The port of the JAX package's ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell for a 16x16 or 2x16x16 TPU mesh and records
XLA's memory and cost analyses.  PyTorch has no such compiler, so the port
does what it can know from one process:

  * it builds the cell's arguments as meta tensors (shapes and dtypes, no
    storage; ``launch.specs``) and runs the step once on them under
    ``torch.utils.flop_counter.FlopCounterMode``: that proves the shapes
    compose at full width and depth and counts the step's flops (its
    global count: the trace is one process over the global shapes);
  * it sizes each device's share of every argument and output from the
    shardings (``distributed.sharding``) and the production mesh
    (``launch.mesh``), which holds no devices.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod/--singlepod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --pipeline   # PP trace

Artifacts: $REPRO_CACHE/dryrun_torch/<arch>__<shape>__<mesh>.json and
``pipeline_pp2.json`` (``REPRO_CACHE`` defaults to ``.cache``).  Never
``.../dryrun/``: that is the reference's directory, which its own tests
read.  A cell is traced under ``with mesh:`` of its first mesh, so the
sharding hints record what they would ask of the partitioner
(``Cell.hints``); they change nothing in the trace.

A record holds the reference's fields (``arch``, ``shape``, ``kind``,
``param_mode``, ``mesh``, ``n_devices``, ``seq_len``, ``global_batch``,
``accum_steps`` for train), ``param_dtype``, and in place of XLA's
analyses ``trace_seconds``, ``memory.argument_size_in_bytes`` (every
argument's local shard), ``memory.output_size_in_bytes``,
``memory.alias_size_in_bytes`` (the donated state or cache, the outputs
that are the very argument tensors), ``cost.flops`` and ``model_flops``
(``models.accounting``).  What only a TPU compile gives is named in
``tpu_only``: a one-process trace has no temporaries, no generated code,
no collectives and no HLO.

``--pipeline`` (:func:`run_pipeline_check`) traces the reference's
pipeline cell: qwen2-0.5b's blocks in 2 stages over ``pod`` of the
2x16x16 mesh (``distributed.pipeline``), 4 microbatches of [8, 4096]
tokens.  Its record keeps the reference's keys with the same
substitutions; the staged params are split over ``pod``, the microbatches
and the output replicated.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.pipeline import pipelined_apply, \
    stage_params_of
from repro_torch.distributed.sharding import (
    NamedSharding, P, batch_spec, mesh_axis_sizes, param_sharding,
    sharding_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    decode_input_specs, prefill_input_specs, train_input_specs)
from repro_torch.models.accounting import local_param_bytes, model_flops
from repro_torch.models.blocks import stage_forward, superblock_table
from repro_torch.models.config import ShapeConfig, shapes_for
from repro_torch.models.lm import abstract_model, decode_step, model_specs, \
    prefill
from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
    opt_state_specs
from repro_torch.training.train_loop import TrainConfig, build_train_step
from repro_torch.training.tree import tree_map

#: the params every cell is sized and traced with: bf16, the reference's
#: (``abstract_model(cfg, jnp.bfloat16)``)
PARAM_DTYPE = torch.bfloat16
#: the H100's memory, and the share of it that replicated serve params may
#: take: the reference's 9 of its 16 GiB v5e budget
DEVICE_BYTES = 80e9
SERVE_PARAM_BYTES = 9 / 16 * DEVICE_BYTES

#: what XLA's compile gives the reference and a one-process trace does not
TPU_ONLY = ("compile_seconds", "memory.temp_size_in_bytes",
            "memory.generated_code_size_in_bytes",
            "cost (every key but flops)", "collectives", "hlo_bytes")

#: the reference's pipeline cell (``run_pipeline_check``)
PIPELINE_ARCH = "qwen2-0.5b"
PIPELINE_STAGES, PIPELINE_MICRO, PIPELINE_BM, PIPELINE_SEQ = 2, 4, 8, 4096


def out_dir() -> str:
    return os.path.join(os.environ.get("REPRO_CACHE", ".cache"),
                        "dryrun_torch")


def _accum_for(cfg) -> int:
    if cfg.d_model >= 7000 or cfg.n_layers >= 90:
        return 8
    if cfg.d_model >= 2560:
        return 4
    return 1


def param_mode(cfg, shape: ShapeConfig, mesh) -> str:
    """"serve" (params replicated over the DP axes, TP only) for a decode
    cell whose bf16 params fit a device so; else "train" (ZeRO-3 x TP).
    The reference's rule, its 2-byte params against the card's budget."""
    if shape.kind != "decode":
        return "train"
    serve_bytes = local_param_bytes(cfg, mesh_axis_sizes(mesh), mode="serve",
                                    dtype_bytes=PARAM_DTYPE.itemsize)
    return "serve" if serve_bytes < SERVE_PARAM_BYTES else "train"


def local_bytes(tree, shardings) -> int:
    """One device's bytes of ``tree``'s tensors under ``shardings`` (a
    tree of the same structure; a None leaf or subtree: replicated)."""
    if isinstance(tree, torch.Tensor):
        shape = (shardings.local_shape(tree.shape)
                 if isinstance(shardings, NamedSharding) else tree.shape)
        n = 1
        for d in shape:
            n *= d
        return n * tree.element_size()
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(local_bytes(tree[k], None if shardings is None
                               else shardings[k]) for k in tree)
    return sum(local_bytes(t, None if shardings is None else s)
               for t, s in zip(tree, shardings or [None] * len(tree)))


def _aliased_bytes(out, given, shardings) -> int:
    """Bytes of ``out``'s tensors that are ``given``'s own (the donated
    leaves a step updated in place), under ``shardings``."""
    if isinstance(out, dict):
        return sum(_aliased_bytes(out[k], given[k], shardings[k])
                   for k in out)
    return local_bytes(out, shardings) if out is given else 0


def _on(tree, device):
    """``tree`` with each meta tensor made on ``device`` as zeros."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_on(t, device) for t in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


class Cell:
    """One cell's step and its arguments, and their shardings on a mesh.
    ``step(*args)`` runs it; ``donated`` is the index of the argument the
    step updates in place; ``out_shardings`` has the step's output
    structure.  The arguments are meta tensors, or zeros on ``device``
    when a caller names a real one (a check, at a small config, that the
    meta trace's shapes are a real run's).  They do not depend on the
    mesh: :meth:`on` sets another mesh's shardings and keeps them."""

    def __init__(self, cfg, shape: ShapeConfig, mesh, device="meta"):
        self.cfg, self.shape = cfg, shape
        params = abstract_model(cfg, PARAM_DTYPE)
        self.accum_steps = None
        if shape.kind == "train":
            self.tc = TrainConfig(accum_steps=_accum_for(cfg),
                                  accum_dtype="bfloat16",
                                  opt=AdamWConfig(quantize_moments=True))
            self.accum_steps = self.tc.accum_steps
            state = {"params": params, "opt": adamw_init(params, self.tc.opt)}
            batch, _ = train_input_specs(cfg, shape, mesh)
            self.step = build_train_step(cfg, self.tc)
            self.args = (state, batch,
                         torch.empty((), dtype=torch.int32, device="meta"))
            self.donated = 0
        elif shape.kind == "decode":
            (token, cache, cur_len), _ = decode_input_specs(cfg, shape, mesh)

            def serve_step(params, tok, cch, cl):
                return decode_step(params, cfg, tok, cch, cl,
                                   donate_cache=True)

            self.step = torch.no_grad()(serve_step)
            self.args = (params, token, cache, cur_len)
            self.donated = 2
        elif shape.kind == "prefill":
            batch, _ = prefill_input_specs(cfg, shape, mesh)

            def prefill_step(params, batch):
                return prefill(params, cfg, batch["tokens"], batch.get("aux"))

            self.step = torch.no_grad()(prefill_step)
            self.args = (params, batch)
            self.donated = None
        else:
            raise ValueError(shape.kind)
        if torch.device(device).type != "meta":
            self.args = _on(self.args, device)
        self.on(mesh)

    def on(self, mesh) -> "Cell":
        """This cell on ``mesh``: its param mode and the shardings of its
        arguments and outputs there."""
        cfg, shape = self.cfg, self.shape
        self.mesh = mesh
        self.mode = param_mode(cfg, shape, mesh)
        pspecs = model_specs(cfg, sharding_rules(mesh, mode=self.mode))
        psh = param_sharding(pspecs, mesh)
        if shape.kind == "train":
            osh = param_sharding(opt_state_specs(
                pspecs, self.tc.opt, self.args[0]["params"]), mesh)
            state_sh = {"params": psh, "opt": osh}
            _, batch_sh = train_input_specs(cfg, shape, mesh)
            self.shardings = (state_sh, batch_sh, None)
            self.out_shardings = (state_sh, None)
        elif shape.kind == "decode":
            _, (tok_sh, cache_sh, len_sh) = decode_input_specs(cfg, shape,
                                                               mesh)
            self.shardings = (psh, tok_sh, cache_sh, len_sh)
            self.out_shardings = (None, cache_sh)
        else:
            _, batch_sh = prefill_input_specs(cfg, shape, mesh)
            self.shardings = (psh, batch_sh)
            self.out_shardings = NamedSharding(
                mesh, P(batch_spec(mesh, shape.global_batch, 0)[0], None,
                        "model" if cfg.d_model % 16 == 0 else None))
        return self

    def trace(self):
        """Run the step once under ``FlopCounterMode`` and ``with mesh:``
        of the cell's mesh: (outputs, seconds, flops).  The hints made
        are kept in ``self.hints``."""
        t0 = time.perf_counter()
        with self.mesh as ctx, FlopCounterMode(display=False) as counter:
            out = self.step(*self.args)
        self.hints = ctx.hints
        return out, time.perf_counter() - t0, counter.get_total_flops()

    def record(self, out, seconds: float, flops: int) -> dict:
        """The cell's record on its mesh from one trace's results (the
        trace does not depend on the mesh, so one trace serves both)."""
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        rec = {
            "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
            "param_mode": self.mode,
            "param_dtype": str(PARAM_DTYPE).replace("torch.", ""),
            "mesh": "x".join(str(s) for s in mesh.shape),
            "n_devices": mesh.size,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        }
        if self.accum_steps is not None:
            rec["accum_steps"] = self.accum_steps
        alias = 0
        if self.donated is not None:
            donated_out = out[0] if shape.kind == "train" else out[1]
            alias = _aliased_bytes(donated_out, self.args[self.donated],
                                   self.shardings[self.donated])
        rec["trace_seconds"] = round(seconds, 3)
        rec["memory"] = {
            "argument_size_in_bytes": local_bytes(self.args, self.shardings),
            "output_size_in_bytes": local_bytes(out, self.out_shardings),
            "alias_size_in_bytes": alias,
        }
        rec["cost"] = {"flops": flops}
        rec["model_flops"] = model_flops(cfg, shape)["model_flops"]
        rec["tpu_only"] = list(TPU_ONLY)
        return rec


def run_cells(arch: str, shape: ShapeConfig, meshes, *,
              device="meta") -> list:
    """One trace of (arch, shape) and its record on each of ``meshes``:
    the trace does not depend on the mesh, only the shardings do."""
    cell = Cell(get_config(arch), shape, meshes[0], device=device)
    out, seconds, flops = cell.trace()
    recs = [cell.on(mesh).record(out, seconds, flops) for mesh in meshes]
    for rec in recs:
        mem = rec["memory"]
        print(f"[dryrun] {arch} {shape.name} mesh={rec['mesh']} "
              f"mode={rec['param_mode']} trace={rec['trace_seconds']}s "
              f"flops={flops:.3g} "
              f"model_flops={rec['model_flops']:.3g}")
        print(f"  memory: args={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
              f"out={mem['output_size_in_bytes'] / 1e9:.2f}GB "
              f"alias={mem['alias_size_in_bytes'] / 1e9:.2f}GB a device")
    return recs


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
             device="meta") -> dict:
    return run_cells(arch, shape, [make_production_mesh(multi_pod=multi_pod)],
                     device=device)[0]


def pipeline_stage_fn(cfg):
    """The pipeline's ``stage_fn``: the cell's super-block over a stage's
    reps, returning the residual stream."""
    _, kinds, _, _ = superblock_table(cfg)

    def stage_fn(p_stage, x):
        h, _ = stage_forward(p_stage, None, cfg, kinds, x)
        return h

    return stage_fn


def run_pipeline_check(multi_pod: bool = True) -> dict:
    """The reference's PP-over-pod check on qwen2-0.5b, traced on meta:
    ``PIPELINE_STAGES`` stages over ``pod``, ``PIPELINE_MICRO``
    microbatches of [``PIPELINE_BM``, ``PIPELINE_SEQ``] activations."""
    cfg = get_config(PIPELINE_ARCH)
    mesh = make_production_mesh(multi_pod=multi_pod)
    staged = stage_params_of(abstract_model(cfg, PARAM_DTYPE)["blocks"],
                             PIPELINE_STAGES)
    x_micro = torch.empty((PIPELINE_MICRO, PIPELINE_BM, PIPELINE_SEQ,
                           cfg.d_model),
                          dtype=PARAM_DTYPE, device="meta")
    t0 = time.perf_counter()
    with mesh, torch.no_grad(), \
            FlopCounterMode(display=False) as counter:
        out = pipelined_apply(mesh, pipeline_stage_fn(cfg), staged, x_micro,
                              axis="pod")
    seconds = time.perf_counter() - t0
    spec_p = tree_map(lambda _: NamedSharding(mesh, P("pod")), staged)
    rec = {"arch": PIPELINE_ARCH, "shape": "pipeline_pp2",
           "kind": "pipeline",
           "param_dtype": str(PARAM_DTYPE).replace("torch.", ""),
           "mesh": "x".join(str(n) for n in mesh.shape),
           "trace_seconds": round(seconds, 3),
           "memory": {
               "argument_size_in_bytes": local_bytes((staged, x_micro),
                                                     (spec_p, None)),
               "output_size_in_bytes": local_bytes(out, None),
               "alias_size_in_bytes": 0},
           "cost": {"flops": counter.get_total_flops()},
           "tpu_only": [k for k in TPU_ONLY if k != "hlo_bytes"]}
    mem = rec["memory"]
    print(f"[dryrun] pipeline pp2 mesh={rec['mesh']} "
          f"trace={rec['trace_seconds']}s flops={rec['cost']['flops']:.3g} "
          f"args={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
          f"out={mem['output_size_in_bytes'] / 1e9:.2f}GB a device")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--singlepod", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    directory = out_dir()
    os.makedirs(directory, exist_ok=True)

    if args.pipeline:
        rec = run_pipeline_check()
        path = os.path.join(directory, "pipeline_pp2.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(path + ".tmp", path)
        return

    multi = []
    if args.singlepod or not args.multipod:
        multi.append(False)
    if args.multipod or not args.singlepod:
        multi.append(True)

    failures = []
    archs = [args.arch] if args.arch else sorted(ARCHS)
    for arch in archs:
        for shape in shapes_for(get_config(arch)):
            if args.shape and shape.name != args.shape:
                continue
            paths = {mp: os.path.join(
                directory, f"{arch}__{shape.name}__"
                f"{'2x16x16' if mp else '16x16'}.json") for mp in multi}
            todo = [mp for mp in multi
                    if args.force or not os.path.exists(paths[mp])]
            for mp in multi:
                if mp not in todo:
                    print(f"[skip] {paths[mp]}")
            if not todo:
                continue
            try:
                recs = run_cells(arch, shape, [
                    make_production_mesh(multi_pod=mp) for mp in todo])
                for mp, rec in zip(todo, recs):
                    with open(paths[mp] + ".tmp", "w") as f:
                        json.dump(rec, f, indent=1)
                    os.replace(paths[mp] + ".tmp", paths[mp])
            except Exception as e:
                failures.append((arch, shape.name, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall requested cells traced")


if __name__ == "__main__":
    main()
