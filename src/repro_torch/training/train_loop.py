"""The train step and the fault-tolerant host loop.

The port of the JAX package's ``repro/training/train_loop.py``.  The step
runs eagerly: microbatched gradient accumulation (a Python loop over
``accum_steps`` microbatches into an f32 or bf16 buffer), AdamW
(optionally 8-bit moments), warmup-cosine LR.  The update goes in place
(:func:`~repro_torch.training.optimizer.adamw_update`), the counterpart of
the reference's donated state: a step returns the state it was given,
updated, and holds no second copy of it.  The step reads nothing back to
the host; its loss comes back as a tensor.

The host ``Trainer`` provides the reference's operational posture:
auto-resume from the latest valid checkpoint, async checkpointing,
heartbeat file + straggler watchdog (step time > factor x rolling median
-> warning callback), SIGTERM preemption handling (checkpoint + clean
exit), and deterministic data replay.  Its ``float()`` of the step's
metrics is its one host sync a step, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.lm import init_model, train_loss
from repro_torch.training.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint)
from repro_torch.training.data import SyntheticLoader
from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
    adamw_update
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.tree import tree_leaves, tree_map

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 100
    accum_steps: int = 1
    accum_dtype: str = "float32"      # float32 | bfloat16
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    opt: AdamWConfig = AdamWConfig()


def _split_accum(batch, accum: int):
    def r(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{accum} microbatches")
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))

    return {k: r(v) for k, v in batch.items()}


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the gradient tree has
    ``params``' structure, zeros where the loss does not reach a leaf.  The
    params are differentiated through views that share their storage, so
    nothing is copied and no ``.grad`` is left behind."""
    diff = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(diff, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(diff),
                                     allow_unused=True))

    def leaf(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(leaf, diff)


def build_train_step(model_cfg, tc: TrainConfig):
    """Returns step(state, batch, step_idx) -> (state, metrics)."""

    def loss_fn(params, mb):
        return train_loss(params, model_cfg, mb)

    def step(state, batch, step_idx):
        lr = warmup_cosine(step_idx, peak_lr=tc.peak_lr,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.total_steps)
        params = state["params"]
        if tc.accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            stacked = _split_accum(batch, tc.accum_steps)
            acc_dt = ACCUM_DTYPES[tc.accum_dtype]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            losses = []
            for i in range(tc.accum_steps):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in stacked.items()})
                tree_map(lambda a, gg: a.add_(gg.to(a.dtype)), grads, g)
                losses.append(l)
                del g
            tree_map(lambda a: a.div_(tc.accum_steps), grads)
            loss = torch.stack(losses).mean()
        adamw_update(grads, state["opt"], params, tc.opt, lr)
        return state, {"loss": loss.float(), "lr": lr}

    return step


def init_train_state(model_cfg, tc: TrainConfig, generator: torch.Generator,
                     device=None, dtype=torch.float32):
    """``{"params", "opt"}``: the model's params in ``dtype`` drawn from
    ``generator`` (:func:`~repro_torch.models.lm.init_model`) and zero
    AdamW moments (f32, or int8 with f32 scales), on ``device`` (default
    the card)."""
    params = init_model(model_cfg, generator, device, dtype)
    return {"params": params, "opt": adamw_init(params, tc.opt)}


def build_sparse_ffn_train_step(ffn, *, lr: float = 1e-3,
                                opt: AdamWConfig = AdamWConfig(),
                                loss_fn=None):
    """Sparse-FFN training step with the SpGEMM stream inside.

    ``ffn`` is a :class:`~repro_torch.models.sparse_ffn.SparseFFN` whose
    matmuls run the differentiable spgemm path (``from_params(...,
    path="spgemm")``).  Returns ``(step, state)`` where ``step(state, (x,
    y)) -> (state, metrics)`` runs the forward (three replays of the
    plans' product stream), the loss (MSE by default; pass
    ``loss_fn(pred, y)`` to override), the backward (two more replays per
    matrix through the same indices) and an in-place AdamW update of the
    sparse weight *values* (copies of the FFN's own, which stay as they
    are).  The weight patterns are static, so the first step per token
    count plans once and every later step replays the plans: no planning
    and no host sync (the loss comes back as a tensor).
    """
    params = {k: v.detach().clone()
              for k, v in ffn.trainable_params().items()}
    state = {"params": params, "opt": adamw_init(params, opt)}
    loss_fn = loss_fn or (lambda pred, y: torch.mean((pred - y) ** 2))

    def objective(p, batch):
        x, y = batch
        return loss_fn(ffn.apply(p, x), y)

    def step(state, batch):
        loss, grads = value_and_grad(objective, state["params"], batch)
        adamw_update(grads, state["opt"], state["params"], opt, lr)
        return state, {"loss": loss.float()}

    return step, state


class Trainer:
    """Host loop with the fault-tolerance drill."""

    def __init__(self, model_cfg, tc: TrainConfig, loader: SyntheticLoader,
                 state, *, on_warning: Optional[Callable] = None):
        self.model_cfg = model_cfg
        self.tc = tc
        self.loader = loader
        self.state = state
        self.step_idx = 0
        self.on_warning = on_warning or (lambda msg: print(f"[warn] {msg}"))
        self._step = build_train_step(model_cfg, tc)
        self._ckpt = (AsyncCheckpointer(tc.checkpoint_dir)
                      if tc.checkpoint_dir else None)
        self._durations: list[float] = []
        self._preempted = False
        self.metrics_log: list[dict] = []

    # -- fault tolerance ---------------------------------------------------

    def install_preemption_handler(self, sig=signal.SIGTERM):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(sig, handler)

    def try_resume(self) -> bool:
        if not self.tc.checkpoint_dir:
            return False
        path = latest_checkpoint(self.tc.checkpoint_dir)
        if path is None:
            return False
        self.state, step, extra = restore_checkpoint(path, self.state)
        self.step_idx = step
        self.loader = SyntheticLoader.restore(
            self.loader.cfg, extra.get("data", {"step": step,
                                                "seed": self.loader.cfg.seed}),
            device=self.loader.device)
        print(f"[resume] restored step {step} from {path}")
        return True

    def _heartbeat(self):
        if not self.tc.checkpoint_dir:
            return
        os.makedirs(self.tc.checkpoint_dir, exist_ok=True)
        hb = os.path.join(self.tc.checkpoint_dir, "heartbeat.json")
        with open(hb, "w") as f:
            json.dump({"step": self.step_idx, "time": time.time()}, f)

    def _watchdog(self, dt: float):
        self._durations.append(dt)
        hist = self._durations[-50:]
        if len(hist) >= 10:
            med = float(np.median(hist[:-1]))
            if dt > self.tc.straggler_factor * med:
                self.on_warning(
                    f"straggler: step {self.step_idx} took {dt:.2f}s "
                    f"(median {med:.2f}s)")

    def checkpoint(self):
        """Save the state and the data position asynchronously (a host
        snapshot now, the write on a background thread)."""
        if self._ckpt:
            self._ckpt.save(self.step_idx, self.state,
                            extra={"data": self.loader.state()})

    def wait_checkpoint(self):
        """Block until the last checkpoint is on disk (``run`` does this at
        its end); raises what its write raised."""
        if self._ckpt:
            self._ckpt.wait()

    # -- the loop ------------------------------------------------------------

    def run(self, n_steps: int | None = None) -> list[dict]:
        end = self.tc.total_steps if n_steps is None \
            else self.step_idx + n_steps
        while self.step_idx < end and not self._preempted:
            batch = next(self.loader)
            t0 = time.perf_counter()
            self.state, metrics = self._step(self.state, batch,
                                             self.step_idx)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step_idx += 1
            self._watchdog(dt)
            self._heartbeat()
            metrics.update(step=self.step_idx, sec=dt)
            self.metrics_log.append(metrics)
            if self.step_idx % self.tc.log_every == 0:
                print(f"step {self.step_idx:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} {dt*1e3:.0f}ms")
            if (self.tc.checkpoint_every
                    and self.step_idx % self.tc.checkpoint_every == 0):
                self.checkpoint()
        if self._preempted:
            print("[preempt] saving final checkpoint")
            self.checkpoint()
        self.wait_checkpoint()
        return self.metrics_log
