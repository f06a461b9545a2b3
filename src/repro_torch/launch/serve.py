"""Serving launcher: plan with the paper's search, then serve on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 64 --prompt-lens 64,128,256 --decode-len 32

Runs the FULL-size model (seeded random weights, every weight resident on
the device).  The planner searches the
plan on the full config with the ``H100-SXM-80GB`` profile; the launcher
then pins omega = 0 and full residency, which this slice of the port
serves, and says so.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import Plan
from repro_torch.core.hardware import PROFILES
from repro_torch.data.datasets import DatasetSpec, synthetic_requests


def build_plan(cfg, hw, args) -> Plan:
    """Search the decode plan on ``cfg`` and realise it for this slice."""
    ctx = max(args.prompt_lens) + args.decode_len
    res = planner.search_decode(cfg, hw, ctx=ctx, decode_len=args.decode_len,
                                scheduler=args.scheduler)
    print(f"planned ({cfg.name} on {hw.name}): {res.plan.describe()}")
    print(f"predicted decode throughput (cost model): "
          f"{res.estimate.throughput:.0f} tok/s")
    B = min(args.batch, args.requests)
    plan = Plan(
        B=B,
        b_a=max(1, min(res.plan.b_a, B)),
        b_e=args.b_e if args.b_e else res.plan.b_e,
        omega=0.0,
        s_params=float(W.model_bytes(cfg)),
        s_expert=0.0,
    )
    # the fused chunk T from the admission cadence at this batch (the
    # cadence scales with B, so the full-config T would over- or under-chunk)
    plan = replace(plan, decode_chunk=planner.select_decode_chunk(
        plan, args.decode_len, scheduler=args.scheduler))
    print(f"realised: B={plan.B} b_a={plan.b_a} b_e={plan.b_e}, fused decode chunk "
          f"T={plan.decode_chunk} ({args.scheduler} cadence); pinned "
          f"omega=0 (planned {res.plan.omega:.1f}) and every weight resident "
          f"({W.model_bytes(cfg) / 1e9:.1f} GB): host attention and weight "
          f"streaming are later slices of the port")
    return plan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--profile", default="H100-SXM-80GB", choices=PROFILES)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--prompt-lens", default="64,96,128,160,192,224,256",
                    help="comma-separated prompt lengths cycled over requests")
    ap.add_argument("--decode-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=64,
                    help="accumulated batch B (engine slots)")
    ap.add_argument("--b-e", type=int, default=None,
                    help="per-expert decode capacity (default: the plan's)")
    ap.add_argument("--scheduler", default="static",
                    choices=("static", "continuous"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.prompt_lens = [int(x) for x in args.prompt_lens.split(",")]

    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.scheduler import serve_dataset

    cfg = get_config(args.arch)
    plan = build_plan(cfg, PROFILES[args.profile], args)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=args.seed, device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"initialised {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) on "
          f"{args.device} in {time.perf_counter() - t0:.1f}s")
    spec = DatasetSpec("serve", args.requests, max(args.prompt_lens),
                       args.decode_len)
    requests = synthetic_requests(spec, cfg.vocab_size, seed=args.seed,
                                  prompt_lens=args.prompt_lens)
    report = serve_dataset(cfg, params, requests, plan, args.decode_len,
                           scheduler=args.scheduler, device=args.device)
    print(f"[{report.scheduler}] served {len(report.request_results)} requests: "
          f"prefill {report.prefill_tokens} tokens in {report.prefill_s:.3f}s "
          f"({report.prefill_throughput:.1f} tok/s), decode "
          f"{report.decode_tokens} tokens in {report.decode_s:.3f}s "
          f"({report.decode_throughput:.1f} tok/s), "
          f"{report.expert_tokens_dropped} routed copies dropped")
    print(f"decode slot-steps {report.decode_slot_steps} (wasted "
          f"{report.wasted_slot_steps}, occupancy {report.occupancy:.0%}); "
          f"TTFT p50 {report.ttft_percentile(50):.3f}s, TPOT p50 "
          f"{report.tpot_percentile(50) * 1e3:.1f}ms")
    toks = np.concatenate([r.tokens for r in report.request_results])
    print(f"generated token ids in [{toks.min()}, {toks.max()}]")


if __name__ == "__main__":
    main()
