"""Quickstart on the PyTorch port: plan a batching strategy and serve a
small MoE with it.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card by default (and raises without one); ``--device cpu``
runs the plain CPU path.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core.dag_builder import Plan
from repro_torch.core.engine import ModuleBatchingEngine
from repro_torch.core.hardware import A5000_C2
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def plan_lines(arch: str = "mixtral-8x7b", ctx: int = 768) -> list:
    """The planner's strategy for the full config on the paper's C2 testbed,
    as printed."""
    cfg_full = get_config(arch)
    res = planner.search_decode(cfg_full, A5000_C2, ctx=ctx)
    return [
        f"planned strategy for {cfg_full.name}",
        f"    {res.plan.describe()}",
        f"    predicted decode throughput: {res.estimate.throughput:.0f} tokens/s "
        f"({res.evaluated} configs searched)",
        "    critical path: " + " -> ".join(res.estimate.critical[:5]),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. the paper's model (full config) + its planned strategy on C2
    for line in plan_lines():
        print(line)

    # 2. execute module-based batching for real on a smoke-scale variant
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = M.init_params(cfg, seed=0, device=dev)
    B, S, DEC = 8, 32, 12
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    plan = Plan(B=B, b_a=4, b_e=64, omega=0.5)
    engine = ModuleBatchingEngine(cfg, params, plan, max_seq=S + DEC, device=dev)
    tokens = engine.generate(prompts, DEC)
    print("\nengine generated", tuple(tokens.shape), "tokens")
    print("   stats:", engine.stats)


if __name__ == "__main__":
    main()
