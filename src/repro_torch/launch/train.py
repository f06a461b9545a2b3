"""Training launcher: the smoke config (or ``--full``), on one device or on
a mesh of rank processes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --ranks 2 --steps 3

Seeded random weights, ``data.synthetic_batches``, ``train.train_loop`` (the
loss with remat, AdamW, a checkpoint at ``--checkpoint``).  ``--device`` is
``cuda`` by default and raises without CUDA; ``--device cpu`` runs the same
path on the CPU.  ``--ranks N`` is the reference's multi-device branch: N
gloo rank processes (``launch.mesh.spawn``; rank r on CUDA device r modulo
the cards there are) on a mesh of data = max(1, N // 16) x model = N //
data, ``seq_shard``, each rank holding its parameter shares, split over
data too as the reference's ``param_shardings(zero1=True)`` places them,
and the AdamW state of the same slices, the batch's rows split over data.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.datasets import synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import train_loop


def _batches(cfg, args, dev, ctx=None):
    """The seeded synthetic batches on ``dev``: this rank's rows on a mesh."""
    for batch in synthetic_batches(cfg.vocab_size, args.batch, args.seq):
        yield tuple(M.rows_of(ctx, torch.from_numpy(a.astype(np.int64))).to(dev)  # lint: allow[MG105] a training batch, placed once a step
                    for a in batch)


def _train(cfg, args, dev, ctx=None):
    params = M.init_params(cfg, seed=0, device=dev, ctx=ctx, zero1=True)
    n = sum(p.numel() for p in tree_leaves(params))
    if ctx is None or ctx.model_rank == ctx.batch_rank == 0:
        where = dev if ctx is None else f"{ctx.mesh.size} ranks, mesh {ctx.mesh.shape}"
        held = "" if ctx is None else " on the first rank"
        print(f"{cfg.name}: {n/1e6:.1f}M params{held}, {args.steps} steps "
              f"of {args.batch}x{args.seq} on {where}")
    _, _, history = train_loop(
        cfg, params, _batches(cfg, args, dev, ctx), steps=args.steps, lr=args.lr,
        log_every=max(1, args.steps // 10),
        checkpoint_path=args.checkpoint,
        checkpoint_every=0 if not args.checkpoint else max(10, args.steps // 2),
        ctx=ctx,
    )
    return history


def rank_main(rank: int, n: int, group, cfg, args):
    """One rank of ``--ranks``: the mesh by the reference's rule, this rank's
    shares, ``seq_shard`` and ZeRO-1."""
    from repro_torch.launch.mesh import make_ctx, make_debug_mesh, mesh_shape_for

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    ctx = make_ctx(make_debug_mesh(*mesh_shape_for(n)), seq_shard=True)
    return _train(cfg, args, dev, ctx)


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
    ap.add_argument("--ranks", type=int, default=0,
                    help="train on a mesh of this many gloo rank processes")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    if args.ranks > 1:
        from repro_torch.launch.mesh import spawn

        return spawn(rank_main, args.ranks, (cfg, args), timeout_s=3600.0)[0]
    return _train(cfg, args, dev)


if __name__ == "__main__":
    main()
