"""Shared helpers of the port's training parity tests
(``tests/test_torch_training*.py``): models at smoke size drawn by the
reference and carried across as numpy, their batches made with numpy from
a seed, and the normwise comparison the tests state."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import config as ref_config
from repro.models import init_model as ref_init_model
from repro_torch.configs import get_config
from repro_torch.models import model_tables, smoke
from repro_torch.models.params import Leaf

FAMILIES = ("qwen2-0.5b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
            "zamba2-2.7b", "llama-3.2-vision-90b", "seamless-m4t-large-v2")
XGATE = 0.5   # the VLM's cross-attention gates: at their init, 0, the
              # cross-attention weights would get no gradient at all


def normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def well_scaled(cfg, tree):
    """``tree`` (numpy) with every stacked ``fan_in`` leaf rescaled from the
    reference's std 1/sqrt(n_rep) to 1/sqrt(d_in) (C9: the reference's rule
    saturates the softmax, and a last-place difference then moves a
    logit)."""

    def walk(t, p):
        if isinstance(t, Leaf):
            if t.init == "fan_in" and t.axes[0] == "layers" \
                    and len(t.shape) >= 3:
                return (p * (t.shape[0] / t.shape[-2]) ** 0.5).astype(
                    np.float32)
            return p
        return {k: walk(t[k], p[k]) for k in p}

    return walk(model_tables(cfg), tree)


def family_model(arch: str, seed: int = 0):
    """(port cfg, reference cfg, numpy params) at smoke size: the
    reference's draw, well scaled, every ``xgate`` at XGATE."""
    cfg, ref_cfg = smoke(get_config(arch)), ref_config.smoke(REF_ARCHS[arch])
    tree = jax.tree_util.tree_map(
        np.asarray, ref_init_model(ref_cfg, jax.random.PRNGKey(seed)))
    for sub in tree["blocks"].values():
        if "xgate" in sub:
            sub["xgate"] = np.full_like(sub["xgate"], XGATE)
    return cfg, ref_cfg, well_scaled(cfg, tree)


def batch_for(cfg, b: int, s: int, seed: int = 0) -> dict:
    """A numpy batch: tokens, next-token labels and, for the
    cross-attention families, the memory's embeddings ``aux``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    if cfg.family in ("vlm", "encdec"):
        n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
        batch["aux"] = rng.normal(size=(b, n, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and PyTorch's thread pool in each worker would oversubscribe
    them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
