"""End-to-end training on the port: a qwen2-family reduced model on
the synthetic learnable stream, with checkpointing + auto-resume, on the
card (``repro_torch.training``).

    python examples/torch_train_lm.py                  # ~15M, quick
    python examples/torch_train_lm.py --size 100m --steps 300
    python examples/torch_train_lm.py --device cpu --steps 2

The presets and flags are ``examples/train_lm.py``'s.  ``--device``
defaults to the card and is refused without one; ``cpu`` runs every step
on the host.  Checkpoints land in ``.cache/torch_train_lm/<size>`` under
the working directory; rerunning resumes automatically.
"""

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model_tables, smoke  # noqa: E402
from repro_torch.models.params import Leaf  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig, DataConfig, SyntheticLoader, TrainConfig, Trainer,
    init_train_state,
)

PRESETS = {
    # name: (d_model, n_layers, n_heads, n_kv, d_head, d_ff, vocab, seq, batch)
    "15m": (256, 4, 4, 2, 64, 1024, 4096, 128, 8),
    "100m": (640, 10, 10, 2, 64, 2560, 16384, 256, 8),
}


def build_cfg(size: str):
    d, l, h, kv, dh, ff, v, seq, batch = PRESETS[size]
    base = smoke(get_config("qwen2-0.5b"))
    cfg = dataclasses.replace(
        base, n_layers=l, d_model=d, n_heads=h, n_kv_heads=kv, d_head=dh,
        d_ff=ff, vocab=v, attn_q_chunk=seq, attn_kv_chunk=seq,
        logits_chunk=min(seq, 128))
    return cfg, seq, batch


def n_params(table) -> int:
    if isinstance(table, Leaf):
        n = 1
        for s in table.shape:
            n *= s
        return n
    return sum(n_params(t) for t in table.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=sorted(PRESETS), default="15m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg, seq, batch = build_cfg(args.size)
    print(f"model: {args.size} "
          f"({n_params(model_tables(cfg)) / 1e6:.1f}M params), "
          f"seq={seq} batch={batch}")

    tc = TrainConfig(
        total_steps=args.steps, peak_lr=args.lr, warmup_steps=args.steps // 10,
        checkpoint_dir=f".cache/torch_train_lm/{args.size}",
        checkpoint_every=20, log_every=5,
        opt=AdamWConfig(quantize_moments=True))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=0, noise=0.05)
    loader = SyntheticLoader(dcfg, device=args.device)
    gen = torch.Generator(device=loader.device).manual_seed(0)
    state = init_train_state(cfg, tc, gen, device=loader.device)
    trainer = Trainer(cfg, tc, loader, state)
    trainer.install_preemption_handler()
    trainer.try_resume()
    log = trainer.run()
    if log:
        first = sum(m["loss"] for m in log[:3]) / max(len(log[:3]), 1)
        last = sum(m["loss"] for m in log[-3:]) / max(len(log[-3:]), 1)
        print(f"\nloss {first:.3f} -> {last:.3f} over {len(log)} steps "
              f"({'DECREASED' if last < first else 'no decrease yet'})")
    trainer.checkpoint()
    trainer.wait_checkpoint()
    print("checkpoint saved; rerun to resume")
    return log


if __name__ == "__main__":
    main()
