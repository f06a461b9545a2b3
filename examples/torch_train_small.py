"""Train a ~100M-parameter MoE for a few hundred steps with the PyTorch port.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200] [--device cpu]

``--smoke`` trains OLMoE's smoke config instead (a quick check).  The
checkpoint goes to the system's temporary directory unless ``--checkpoint``
names a file.
"""
import argparse
import os
import tempfile
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.data.datasets import synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.train_loop import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file (default: repro_torch_ckpt.npz in the "
                         "temporary directory), written every 100 steps")
    ap.add_argument("--smoke", action="store_true",
                    help="train the OLMoE smoke config instead of the ~100M model")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.checkpoint or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt.npz")

    # a ~100M-param OLMoE-family model (keeps the 64e top-8 routing scaled to 8e)
    base = get_config("olmoe-1b-7b", smoke=True)
    cfg = base if args.smoke else replace(
        base,
        name="olmoe-100m",
        num_layers=4,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        num_experts=8,
        experts_per_token=2,
        moe_d_ff=1024,
        vocab_size=32_000,
    )
    n = cfg.param_counts()["total"]
    print(f"training {cfg.name}: {n/1e6:.0f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq}")
    params = M.init_params(cfg, seed=0, device=dev)
    batches = iter(
        (torch.from_numpy(t).long().to(dev), torch.from_numpy(l).long().to(dev))
        for t, l in synthetic_batches(cfg.vocab_size, args.batch, args.seq)
    )
    params, _, history = train_loop(
        cfg, params, batches, steps=args.steps, lr=1e-3, log_every=args.log_every,
        checkpoint_path=ckpt, checkpoint_every=100,
    )
    assert history[-1]["loss"] < history[0]["loss"], "loss did not decrease"
    print("final loss:", history[-1]["loss"])


if __name__ == "__main__":
    main()
