"""Training launcher: the smoke config (or ``--full``) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

Seeded random weights, ``data.synthetic_batches``, ``train.train_loop`` (the
loss with remat, AdamW, a checkpoint at ``--checkpoint``).  ``--device`` is
``cuda`` by default and raises without CUDA; ``--device cpu`` runs the same
path on the CPU.  It trains on ONE device: the reference's multi-device
branch (a data x model mesh, sharded parameters and ZeRO-1 optimizer state)
belongs to the model-sharding path, which the port does not have yet.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.datasets import synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (it must fit one device with its "
                         "gradients and f32 AdamW moments)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    params = M.init_params(cfg, seed=0, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params, {args.steps} steps "
          f"of {args.batch}x{args.seq} on {dev}")
    batches = (
        tuple(torch.from_numpy(a.astype(np.int64)).to(dev)  # lint: allow[MG105] a training batch, placed once a step
              for a in batch)
        for batch in synthetic_batches(cfg.vocab_size, args.batch, args.seq)
    )
    train_loop(
        cfg, params, batches, steps=args.steps, lr=args.lr,
        log_every=max(1, args.steps // 10),
        checkpoint_path=args.checkpoint,
        checkpoint_every=0 if not args.checkpoint else max(10, args.steps // 2),
    )


if __name__ == "__main__":
    main()
