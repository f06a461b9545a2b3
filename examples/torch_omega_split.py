"""The host/device attention split omega on the PyTorch port (paper Fig. 7
/ §B).

Runs the same decode batch at several omega values on the real engine,
reports token agreement with omega 0 (the host mechanism rounds bf16
otherwise than the device's, so greedy tokens part after a near tie, as in
the JAX example), checks that rows ``[0, round(omega * B))`` attended on
the host CPU and the rest on the device, and prints the planner's predicted
throughput curve for the paper's C1 testbed alongside.

    PYTHONPATH=src python examples/torch_omega_split.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core.dag_builder import Plan
from repro_torch.core.engine import ModuleBatchingEngine
from repro_torch.core.hardware import A5000_C1
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("mixtral-8x7b", smoke=True)
    params = M.init_params(cfg, seed=0, device=dev)
    B, S, DEC = 8, 16, 8
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    gen = torch.Generator(device="cpu").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)

    ref_tokens = None
    print("omega  host_tokens  device_tokens  agreement")
    for w in (0.0, 0.5, 1.0):
        eng = ModuleBatchingEngine(cfg, params, Plan(B=B, b_a=4, b_e=64, omega=w),
                                   max_seq=S + 8, device=dev)
        out = eng.generate(toks, DEC)
        if ref_tokens is None:
            ref_tokens = out
            agree = 1.0
        else:
            agree = float((out == ref_tokens).float().mean())
        print(f"{w:4.1f}  {eng.stats.host_attn_tokens:11d}  "
              f"{eng.stats.device_attn_tokens:13d}  {agree:9.2%}")
        rows = (DEC - 1) * n_attn        # decode ticks x attention layers
        assert eng.stats.host_attn_tokens == round(w * B) * rows, eng.stats
        assert eng.stats.device_attn_tokens == (B - round(w * B)) * rows, eng.stats
        del eng

    print("\nplanner-predicted decode throughput vs omega (C1, full model):")
    full = get_config("mixtral-8x7b")
    for i in range(0, 11, 2):
        w = i / 10
        res = planner.search_decode(full, A5000_C1, 272, omega_grid=[w])
        print(f"  w={w:.1f}: {res.estimate.throughput:7.0f} tokens/s")


if __name__ == "__main__":
    main()
