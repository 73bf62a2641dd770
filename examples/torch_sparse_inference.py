"""Serving with the paper's technique as a first-class feature, on the
port: FFN weights pruned to block-sparse and run through the
density-adaptive hybrid policy (a dense matmul or the BSR kernel K5), plus
batched request serving through the continuous-batching engine
(``repro_torch``).

    python examples/torch_sparse_inference.py                 # on the card
    python examples/torch_sparse_inference.py --device cpu    # plain versions

The port's copy of ``examples/sparse_inference.py``, with the same models,
keeps and requests.  ``--device`` defaults to the card and is refused
without one; ``cpu`` runs each kernel's plain PyTorch version on the host.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import SparseFFN, init_model, smoke  # noqa: E402
from repro_torch.models.layers import ffn  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke(get_config("granite-20b"))
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ffn_params = {k: {"w": v["w"][0]}                     # layer-0 FFN
                  for k, v in params["blocks"]["l0"]["ffn"].items()}

    print("=== density-adaptive policy (the paper's t-switch) ===")
    print(f"{'keep':>6s} {'path':>6s} {'flop savings':>13s} {'rel err':>9s}")
    x = torch.randn((16, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    dense_y = ffn(ffn_params, x[None])[0]
    dense_flops = 3 * 2 * cfg.d_model * cfg.d_ff
    for keep in (0.9, 0.5, 0.25, 0.1):
        sp = SparseFFN.from_params(ffn_params, keep_density=keep,
                                   t_density=0.75, device=dev)
        y = sp(x)
        # against the unpruned output: the pruning's loss
        rel = float(torch.linalg.norm(y - dense_y)
                    / torch.linalg.norm(dense_y))
        print(f"{keep:6.2f} {sp.gate.path:>6s} "
              f"{dense_flops / sp.flops_per_token:12.2f}x {rel:9.3f}")

    print("\n=== batched serving (continuous batching engine) ===")
    srv_cfg = smoke(get_config("qwen2-0.5b"))
    srv_params = init_model(srv_cfg,
                            torch.Generator(device=dev).manual_seed(2),
                            device=dev)
    eng = ServeEngine(srv_cfg, srv_params, max_batch=3, cache_len=96,
                      device=dev)
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, srv_cfg.vocab, size=5).tolist(),
                       max_new_tokens=8, temperature=0.0)
            for _ in range(6)]
    done = eng.run_to_completion()
    for rid in rids:
        print(f"  request {rid}: generated {done[rid].generated}")
    print(f"served {len(done)} requests on {eng.max_batch} slots")


if __name__ == "__main__":
    main()
