"""Optional pipeline parallelism over the 'pod' axis (GPipe schedule).

The port of the JAX package's ``repro/distributed/pipeline.py``.  The
reference runs the classic GPipe loop under ``shard_map``: stage s holds
slice s of the stacked super-block params, ``n_micro + n_stages - 1``
ticks pass, and at each tick every stage applies itself to the activation
it received at the last tick and ``ppermute``s its output to stage s + 1;
the bubbles are masked compute, and a final ``psum`` over the stages hands
every device the last stage's outputs.

The port drives the stages from one process, as the SpGEMM mesh drives its
shards (``spgemm_mesh.py``): stage s runs on the device of position s
along the stage axis, its params moved there once; the ``ppermute`` is a
``.to()`` onto the next stage's device; the output is the last stage's,
exactly, on ``x_micro``'s device.  An eager loop has nothing to mask, so
the bubbles are skipped: the outputs are the same, and so is every
stage's work on a real microbatch.  Each stage runs inside
``launch.mesh.pipeline_stage``, where the sharding hints record nothing
(the stage owns its layout, as under the reference's manual axes).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.compression import tree_map
from repro_torch.distributed.sharding import mesh_axis_sizes
from repro_torch.launch.mesh import pipeline_stage

__all__ = ["axis_devices", "pipeline_forward", "pipelined_apply",
           "stage_params_of"]


def stage_params_of(stacked, n_stages: int):
    """``stacked``'s leaves ``[n_rep, ...]`` as ``[n_stages, n_rep //
    n_stages, ...]`` views: stage s holds reps ``s·n_rep/n_stages`` on.
    Raises where ``n_stages`` does not divide a leaf's reps, as the
    reference's reshape does."""

    def split(leaf):
        n_rep = leaf.shape[0]
        if n_stages < 1 or n_rep % n_stages:
            raise ValueError(f"{n_stages} stages do not divide a stacked "
                             f"leaf of {n_rep} reps (shape "
                             f"{tuple(leaf.shape)})")
        return leaf.reshape((n_stages, n_rep // n_stages)
                            + tuple(leaf.shape[1:]))

    return tree_map(split, stacked)


def axis_devices(mesh, axis: str) -> list:
    """The device of each position along ``axis`` (the other axes at
    position 0): the one device of a mesh over one, ``"meta"`` for a mesh
    that holds no devices (the production mesh)."""
    sizes = mesh_axis_sizes(mesh)
    n = sizes[axis]
    if mesh.devices is None:
        return [torch.device("meta")] * n
    if len(set(mesh.devices)) == 1:
        return [torch.device(mesh.devices[0])] * n
    stride = 1
    for name in mesh.axis_names[mesh.axis_names.index(axis) + 1:]:
        stride *= sizes[name]
    return [torch.device(mesh.devices[s * stride]) for s in range(n)]


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return next(_leading(v) for v in tree.values())
    return int(tree.shape[0])


def pipeline_forward(stage_fn, n_stages: int, axis: str = "pod"):
    """Build ``fn(stage_params, x_micro, devices=None) -> y_micro``.

    stage_params: tree with a leading stage axis of ``n_stages``.
    x_micro: [n_micro, Bm, S, D] microbatched activations.
    stage_fn(params_slice, x) -> y, applied by every stage to its slice.
    devices: stage s's device (default: every stage on ``x_micro``'s).
    ``axis`` names the stage axis, as in the reference; the port's stages
    are placed by ``devices``.
    """

    def run(stage_params, x_micro, devices=None):
        if _leading(stage_params) != n_stages:
            raise ValueError(
                f"stage params lead with {_leading(stage_params)} stages, "
                f"the pipeline has {n_stages} on axis {axis!r}")
        devs = [x_micro.device] * n_stages if devices is None \
            else list(devices)
        # stage s's slice on its device, once
        params = [tree_map(lambda a, s=s: a[s].to(devs[s]), stage_params)
                  for s in range(n_stages)]
        n_micro = x_micro.shape[0]
        outs = [None] * n_micro
        buf = [None] * n_stages       # what stage s received last tick
        for t in range(n_micro + n_stages - 1):
            nxt = [None] * n_stages
            for s in range(n_stages):
                x_in = x_micro[t].to(devs[0]) if s == 0 and t < n_micro \
                    else buf[s]
                if x_in is None:      # a bubble
                    continue
                with pipeline_stage():
                    y = stage_fn(params[s], x_in)
                if s == n_stages - 1:
                    outs[t - (n_stages - 1)] = y.to(x_micro.device)
                else:
                    nxt[s + 1] = y.to(devs[s + 1])
            buf = nxt
        return torch.stack(outs)

    return run


def pipelined_apply(mesh, stage_fn, stage_params, x_micro,
                    axis: str = "pod"):
    """``pipeline_forward`` over ``mesh``'s ``axis``: stage s on the device
    of position s along it; stage_params' leading dim == the axis size."""
    n_stages = mesh_axis_sizes(mesh)[axis]
    run = pipeline_forward(stage_fn, n_stages, axis)
    return run(stage_params, x_micro, axis_devices(mesh, axis))
