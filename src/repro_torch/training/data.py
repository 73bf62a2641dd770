"""Deterministic synthetic token pipeline.

The port of the JAX package's ``repro/training/data.py``, its own numpy
copy, equal to the reference's bit for bit: batch ``i`` is a pure function
of (seed, i), so resume-after-failure replays the exact stream from the
checkpointed step with no iterator state to persist.  The loader lifts
each batch to its ``device`` (default the card), the counterpart of the
reference's ``device_put``.

The synthetic LM task is learnable: each sequence interleaves affine-map
segments t_{i+1} = (a*t_i + b) mod V with uniform-noise tokens, so a model
can learn the deterministic bigram structure but not memorise sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    n_maps: int = 8           # distinct affine maps (sub-languages)


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """{'tokens': [B,S] int32, 'labels': [B,S] int32} for this step (numpy,
    on the host)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    maps_a = 1 + 2 * rng.integers(1, max(v // 7, 2), size=cfg.n_maps)
    maps_b = rng.integers(0, v, size=cfg.n_maps)
    which = rng.integers(0, cfg.n_maps, size=b)
    a = maps_a[which][:, None]
    bb = maps_b[which][:, None]
    toks = np.empty((b, s + 1), np.int64)
    toks[:, 0] = rng.integers(0, v, size=b)
    for i in range(s):
        toks[:, i + 1] = (a[:, 0] * toks[:, i] + bb[:, 0]) % v
    noise_mask = rng.uniform(size=(b, s + 1)) < cfg.noise
    noise_tok = rng.integers(0, v, size=(b, s + 1))
    toks = np.where(noise_mask, noise_tok, toks)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class SyntheticLoader:
    """Iterator facade with explicit step addressing (resumable); yields
    each batch as int32 tensors on ``device`` (default the card)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        batch = synth_batch(self.cfg, self.step)
        self.step += 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict,
                device=None) -> "SyntheticLoader":
        if state["seed"] != cfg.seed:
            raise ValueError(f"data seed mismatch on resume: the checkpoint "
                             f"has {state['seed']}, the config {cfg.seed}")
        return cls(cfg, start_step=state["step"], device=device)
