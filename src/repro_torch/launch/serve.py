"""Serving launcher: plan with the paper's search, then serve on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 64 --prompt-lens 64,128,256 --decode-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --requests 64 --prompt-lens 128,256,512 --decode-len 16 \
        --stream-weights --resident-gb 60
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 32 --batch 32 --decode-len 64 --prompt-lens 1024,2048,3584 \
        --omega 0 --kv-page-tokens 128 --device-kv-gb 7.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --requests 128 --prompt-lens 64,128,256 --decode-lens 8,32,128 \
        --eos-id 7 --scheduler continuous --arrival-rate 20 --omega 0

Runs the FULL-size model on seeded random weights.  The planner searches
the plan on the full config with the ``H100-SXM-80GB`` profile and the
launcher serves its omega (the share of the batch whose attention runs on
the host CPU), unless ``--omega`` overrides it.  ``--kv-page-tokens`` pages
the KV cache and ``--device-kv-gb`` caps its device pool, the rest of the
frames living in page-locked host memory; ``--prefix-cache`` (with
``--kv-page-tokens``) admits a prompt whose page-aligned prefix was served
before by copying the stored prefix KV and prefilling only the suffix (the
synthetic prompts here share none, so it reports its lookups as misses).
Every weight is resident unless
``--stream-weights`` (or
``--resident-gb`` / ``--predict-topk``): then the store keeps the greedy
resident set on the card and the rest in page-locked host memory, built
layer by layer (``ParamStore.seeded``) so that a model larger than the
card never has to fit on it.  The traffic is the reference launcher's
(``build_requests``): ``--prompt-len`` or the cycled ``--prompt-lens``,
``--decode-len`` or the cycled ``--decode-lens``, ``--eos-id`` finishing a
sequence early, open-loop arrivals from ``--arrival-rate`` (Poisson) or
``--arrival-trace`` (offsets), and ``--temperature`` / ``--top-k``
sampling; ``--seed`` seeds the weights, the arrivals and the sampling.
Under ``--scheduler continuous`` admission is gated by Eq. 2's host KV
budget of ``--profile``.  ``--faults SPEC`` arms deterministic fault
injection (``repro_torch.faults`` grammar, e.g.
``seed=7,transfer=0.05,stall=0.02,oom=0.05,preempt=8``) and prints the
recovery counters; the tokens are those of the unarmed run.
``--sanitize strict|log`` serves under the analysis sanitizer and prints its
report: the planned reads by tag, steady-state captures, pointer checks.
``--smoke`` serves the architecture's smoke config (the plan is still
searched on the full one), which is what the CPU can run:
``--smoke --device cpu --sanitize strict --faults ...``.  ``--mesh DP,EP``
serves DP replicas behind one queue (``distributed.ReplicaServer``, with
``--faults kill=R@N`` failing a replica over), each an expert-parallel group
of EP rank processes on gloo (``launch.mesh.spawn``; ``--mesh 1,2`` puts
two ranks on one card); the ranks' tokens must agree, and rank 0's report is
printed.  ``--expert-path loop`` decodes through the per-expert loop
oracle (one planned host read of each MoE layer's routing a tick) instead
of the grouped dispatch.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import Plan
from repro_torch.core.hardware import PROFILES
from repro_torch.data.datasets import DatasetSpec, synthetic_requests
from repro_torch.serving import arrivals
from repro_torch.serving.sampling import SamplingParams


def build_plan(cfg, hw, args) -> Plan:
    """Search the decode plan on ``cfg`` and realise it for this slice (with
    ``args.mesh`` DP,EP, one expert-parallel replica's plan, whose pipeline
    chunk count ``--ep-chunks`` overrides)."""
    ctx = max(getattr(args, "prompt_lens", None) or [args.prompt_len]) + args.decode_len
    dp, ep = mesh_axes(args)
    res = planner.search_decode(cfg, hw, ctx=ctx, decode_len=args.decode_len,
                                scheduler=args.scheduler,
                                mesh_shape=(dp, ep) if ep > 1 else None)
    print(f"planned ({cfg.name} on {hw.name}): {res.plan.describe()}")
    print(f"predicted decode throughput (cost model): "
          f"{res.estimate.throughput:.0f} tok/s")
    B = min(args.batch, args.requests)
    stream = streams(args)
    omega = getattr(args, "omega", None)
    omega = res.plan.omega if omega is None else float(omega)
    plan = Plan(
        B=B,
        b_a=max(1, min(res.plan.b_a, B)),
        b_e=args.b_e if args.b_e else res.plan.b_e,
        omega=omega,
        s_params=(res.plan.s_params if stream else float(W.model_bytes(cfg))),
        s_expert=res.plan.s_expert if stream else 0.0,
        predict_topk=res.plan.predict_topk if stream else 0,
        ep_chunks=getattr(args, "ep_chunks", None) or res.plan.ep_chunks,
    )
    # the fused chunk T from the admission cadence at this batch (the
    # cadence scales with B, so the full-config T would over- or under-chunk)
    plan = replace(plan, decode_chunk=planner.select_decode_chunk(
        plan, args.decode_len, scheduler=args.scheduler))
    where = ("weights streamed" if stream else
             f"every weight resident ({W.model_bytes(cfg) / 1e9:.1f} GB)")
    print(f"realised: B={plan.B} b_a={plan.b_a} b_e={plan.b_e}, fused decode chunk "
          f"T={plan.decode_chunk} ({args.scheduler} cadence); omega={plan.omega:g} "
          f"(planned {res.plan.omega:g}): {int(round(plan.omega * plan.B))} of {plan.B} "
          f"rows attend on the host; {where}")
    return plan


def build_requests(args, cfg) -> list:
    """The requests the reference launcher builds from the same flags
    (``src/repro/launch/serve.py``): ``synthetic_requests`` at its fixed
    prompt seed 0, ``--prompt-lens`` over ``--prompt-len``, ``--decode-lens``
    over ``--decode-len``, arrival offsets from ``--arrival-trace``, else a
    Poisson process at ``--arrival-rate`` seeded by ``--seed`` (neither: all
    due at 0), and one ``SamplingParams(--temperature, --top-k, --seed)``
    on every request unless it is greedy.  Only the weights differ: the
    port serves the full-size model seeded by ``--seed`` (``init_params``),
    the reference its smoke model from ``PRNGKey(0)``."""
    spec = DatasetSpec("serve", args.requests, args.prompt_len, args.decode_len)
    times = None
    if args.arrival_trace:
        times = arrivals.trace([float(x) for x in args.arrival_trace.split(",")])
    elif args.arrival_rate is not None:
        times = arrivals.poisson(args.requests, args.arrival_rate, seed=args.seed)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, seed=args.seed)
    return synthetic_requests(spec, cfg.vocab_size, prompt_lens=args.prompt_lens,
                              decode_lens=args.decode_lens, arrivals=times,
                              sampling=None if sampling.is_greedy else sampling)


def serve_config(args, **kw):
    """The ``ServeConfig`` of the launcher's flags (``kw`` adds fields):
    ``--eos-id``, and under the continuous scheduler the Eq. 2 host KV
    gate of ``--profile`` (``hw``), as the reference launcher passes them."""
    from repro_torch.serving.server import ServeConfig

    continuous = args.scheduler == "continuous"
    return ServeConfig(scheduler=args.scheduler, decode_len=args.decode_len,
                       eos_id=getattr(args, "eos_id", None),
                       hw=PROFILES[getattr(args, "profile", "H100-SXM-80GB")] if continuous
                       else None,
                       expert_path=args.expert_path, kv_page_tokens=args.kv_page_tokens,
                       device_kv_gb=args.device_kv_gb, prefix_cache=args.prefix_cache, **kw)


def _ints(text):
    """A comma-separated list of ints (None stays None)."""
    return [int(x) for x in text.split(",")] if text else None


def mesh_axes(args) -> tuple:
    """``--mesh DP,EP`` as (dp, ep); (1, 1) without it."""
    text = getattr(args, "mesh", None)
    if not text:
        return 1, 1
    try:
        dp, ep = (int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"--mesh wants DP,EP (got {text!r})")
    if dp < 1 or ep < 1:
        raise SystemExit(f"--mesh axes must be >= 1 (got {text!r})")
    return dp, ep


def streams(args) -> bool:
    """Whether the arguments ask for weight streaming (a namespace without
    the streaming flags asks for none)."""
    return (getattr(args, "stream_weights", False)
            or getattr(args, "resident_gb", None) is not None
            or getattr(args, "predict_topk", None) is not None)


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, the length lists parsed to lists of ints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--profile", default="H100-SXM-80GB", choices=PROFILES)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths cycled over requests "
                         "(overrides --prompt-len), e.g. 64,128,256")
    ap.add_argument("--decode-len", type=int, default=32)
    ap.add_argument("--decode-lens", default=None,
                    help="comma-separated per-request decode lengths cycled over "
                         "requests (overrides --decode-len), e.g. 8,32,128")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id that finishes a sequence early")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="open-loop Poisson arrivals, requests/s (default: every "
                         "request due at 0, the closed-loop drain)")
    ap.add_argument("--arrival-trace", default=None,
                    help="comma-separated arrival offsets in seconds, e.g. "
                         "0,0.5,1.2 (overrides --arrival-rate)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample among the k highest logits (0: off)")
    ap.add_argument("--batch", type=int, default=64,
                    help="accumulated batch B (engine slots)")
    ap.add_argument("--b-e", type=int, default=None,
                    help="per-expert decode capacity (default: the plan's)")
    ap.add_argument("--expert-path", default="grouped", choices=("grouped", "loop"),
                    help="MoE decode stage: grouped dispatch vs per-expert loop (the "
                         "oracle: a host read of the routing per MoE layer and tick)")
    ap.add_argument("--scheduler", default="static",
                    choices=("static", "continuous"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the Poisson arrivals and the sampling")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the smoke config of --arch (plan on the full one)")
    ap.add_argument("--stream-weights", action="store_true",
                    help="keep the planned resident set on the device and "
                         "stream the rest from page-locked host memory, "
                         "prefetched a layer ahead")
    ap.add_argument("--resident-gb", type=float, default=None,
                    help="device GB of the greedy resident weight set "
                         "(implies --stream-weights; default: the plan's "
                         "S_Params)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="fetch each streamed module when it is needed "
                         "(copy and compute serialised)")
    ap.add_argument("--predict-topk", type=int, default=None,
                    help="stream streamed MoE layers per expert, prefetching "
                         "the k-hat experts predicted from the previous "
                         "layer (default: the plan's; 0 streams whole "
                         "stacks; implies --stream-weights)")
    ap.add_argument("--expert-lru-gb", type=float, default=None,
                    help="hot-expert device LRU of predictive streaming, GB "
                         "(default: the residency plan's spare bytes)")
    ap.add_argument("--omega", type=float, default=None,
                    help="share of the batch whose attention runs on the host "
                         "CPU (default: the plan's)")
    ap.add_argument("--kv-page-tokens", type=int, default=0,
                    help="page the KV cache in frames of this many tokens "
                         "(0: contiguous)")
    ap.add_argument("--device-kv-gb", type=float, default=None,
                    help="device GB of the KV page pool; the other frames live "
                         "in page-locked host memory (default: every frame on "
                         "the device)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cache shared prompt prefixes at page granularity and "
                         "admit a hit by copying its stored prefix KV instead of "
                         "recomputing its prefill (requires --kv-page-tokens)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm deterministic fault injection, e.g. 'seed=3,transfer=0.2,"
                         "stall=0.05,oom=0.1,preempt=7' (repro_torch.faults grammar): "
                         "copies retried, stalls re-fetched, page OOMs degraded, "
                         "requests preempted and resumed, all counted; the tokens "
                         "are those of the unarmed run")
    ap.add_argument("--sanitize", default="off", choices=("off", "log", "strict"),
                    help="serve under the analysis sanitizer: decode regions raise "
                         "(strict) or log (log) on host reads outside planned scopes, "
                         "cache pointers are checked every tick; prints the report")
    ap.add_argument("--mesh", default=None, metavar="DP,EP",
                    help="serve on DP data-parallel replicas (one arrival queue, "
                         "repro_torch.distributed.ReplicaServer), each EP expert-parallel "
                         "rank processes joined by a gloo group: rank r owns experts "
                         "[r*E/EP, (r+1)*E/EP) and the MoE decode stage exchanges routed "
                         "copies by all-to-all; all ranks may share one card")
    ap.add_argument("--ep-chunks", type=int, default=None,
                    help="pipeline chunks of the expert-parallel a2a stage (chunk k+1's "
                         "exchange posted before chunk k's FFN; default: the planner's)")
    args = ap.parse_args(argv)
    args.prompt_lens, args.decode_lens = _ints(args.prompt_lens), _ints(args.decode_lens)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    dp, ep = mesh_axes(args)
    if (dp > 1 or ep > 1) and streams(args):
        raise SystemExit("--mesh serves fully resident replicas; it composes with "
                         "neither --stream-weights nor predictive streaming")

    import torch

    from repro_torch import analysis, faults
    from repro_torch.models import model as M
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import Server
    from repro_torch.serving.weights import ParamStore

    cfg = get_config(args.arch)
    plan = build_plan(cfg, PROFILES[args.profile], args)
    if args.smoke:
        cfg = get_config(args.arch, smoke=True)
    requests = build_requests(args, cfg)
    if dp > 1 or ep > 1:
        serve_mesh(args, cfg, plan, requests, dp, ep)
        return
    t0 = time.perf_counter()
    params, store = None, None
    if streams(args):
        store = ParamStore.seeded(
            cfg, args.seed,
            resident_bytes=(plan.s_params if args.resident_gb is None
                            else args.resident_gb * 1e9),
            prefetch=not args.no_prefetch,
            predict_topk=(plan.predict_topk if args.predict_topk is None
                          else args.predict_topk),
            lru_bytes=None if args.expert_lru_gb is None else args.expert_lru_gb * 1e9,
            device=args.device)
        rp = store.residency
        streamed = [i for i in range(cfg.num_layers)
                    if not (rp.mixer_resident[i] and rp.ffn_resident[i])]
        print(f"residency: {store.describe()}; layers with a streamed module: "
              f"{streamed}")
    else:
        params = M.init_params(cfg, seed=args.seed, device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"initialised {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) on "
          f"{args.device} in {time.perf_counter() - t0:.1f}s")
    fault_plan = faults.resolve(args.faults)
    server = Server(cfg, params, plan, serve=serve_config(args, faults=fault_plan),
                    store=store, device=args.device)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    engine = server._engine
    pages = engine.pages
    print(f"host attention: {engine.n_host} of {server._b} rows; KV "
          f"{'contiguous' if pages is None else pages.describe()}; page-locked "
          f"{wmod.pinned_bytes() / 1e9:.3f} GB")
    with (analysis.sanitize(strict=args.sanitize == "strict", pointers=True)
          if args.sanitize != "off" else contextlib.nullcontext()) as san:
        report = server.run()
    print_report(report, args)
    if store is not None:
        print(f"weight streaming: {report.htod_gb:.3f} GB host-to-device, "
              f"copy wait {report.prefetch_wait_s:.3f}s on the card")
        if report.expert_pred_hits or report.expert_pred_misses \
                or report.expert_lru_hits:
            print(f"predictive: hit rate {report.pred_hit_rate:.0%} "
                  f"({report.expert_pred_hits} hits, {report.expert_pred_misses} "
                  f"misses), LRU hit rate {report.lru_hit_rate:.0%}")
    if report.kv_htod_bytes or report.kv_dtoh_bytes or report.host_attn_tokens:
        print(f"KV pages: {report.kv_htod_gb:.3f} GB host-to-device, "
              f"{report.kv_dtoh_gb:.3f} GB device-to-host (the host tier); host "
              f"attention {report.host_attn_tokens} row-layers, "
              f"{engine.stats.host_attn_s:.3f}s of host CPU")
    if fault_plan is not None:
        print(f"faults: ledger {json.dumps(fault_plan.report()['events'])}")
    if san is not None:
        print(f"sanitizer ({args.sanitize}): {json.dumps(san.report(), default=str)}")
    print_tokens(report)


def print_report(report, args) -> None:
    """The served report's lines shared by every launch."""
    print(f"[{report.scheduler}] served {len(report.request_results)} requests: "
          f"prefill {report.prefill_tokens} tokens in {report.prefill_s:.3f}s "
          f"({report.prefill_throughput:.1f} tok/s), decode "
          f"{report.decode_tokens} tokens in {report.decode_s:.3f}s "
          f"({report.decode_throughput:.1f} tok/s), "
          f"{report.expert_tokens_dropped} routed copies dropped")
    print(f"decode slot-steps {report.decode_slot_steps} (wasted "
          f"{report.wasted_slot_steps}, occupancy {report.occupancy:.0%}); "
          f"mean request latency {report.mean_latency_s:.3f}s")
    print(f"TTFT p50/p95 {report.ttft_percentile(50):.3f}/{report.ttft_percentile(95):.3f}s, "
          f"mean {report.mean_ttft_s:.3f}s; TPOT p50/p95 "
          f"{report.tpot_percentile(50) * 1e3:.1f}/{report.tpot_percentile(95) * 1e3:.1f}ms, "
          f"mean {report.mean_tpot_s * 1e3:.1f}ms; mean queue wait "
          f"{report.mean_queue_wait_s:.3f}s")
    if report.expert_load is not None:
        drops = "/".join(str(int(d)) for d in report.expert_dropped_by_layer)
        hist = "/".join(str(int(c)) for c in report.expert_load.sum(axis=0))
        print(f"routing skew {report.routing_skew:.2f}x balanced (per-expert routed "
              f"copies {hist}); per-MoE-layer drops {drops} "
              f"({report.capacity_replans} online capacity re-plans)")
    if report.admission_deferrals:
        print(f"admissions deferred by the Eq. 2 host KV budget: "
              f"{report.admission_deferrals}")
    if args.prefix_cache:
        print(f"prefix cache: {report.prefix_hits} hits / "
              f"{report.prefix_hits + report.prefix_misses} lookups (hit rate "
              f"{report.prefix_hit_rate:.0%})")
    if args.faults:
        print(f"faults: transfer_retries {report.transfer_retries}, transfer_timeouts "
              f"{report.transfer_timeouts}, preemptions {report.preemptions}, resumes "
              f"{report.resumes}, degrade_deferrals {report.degrade_deferrals}, "
              f"page_demotions {report.page_demotions}, chunk_shrinks "
              f"{report.chunk_shrinks}, failovers {report.failovers} "
              f"({report.requeued_requests} requests requeued)")


def print_tokens(report) -> None:
    toks = np.concatenate([r.tokens for r in report.request_results])
    print(f"generated token ids in [{toks.min()}, {toks.max()}]")


def mesh_rank(rank: int, n: int, group, args, cfg, plan, requests):
    """One expert-parallel rank of ``--mesh DP,EP`` (``group`` None: the only
    one): seeded weights on ``args.device``, then ``DP`` replicas behind one
    queue (``ReplicaServer``) or one ``Server``, every engine's MoE decode
    stage collective over ``group``.  Returns (report, per-replica reports
    or None)."""
    import torch

    from repro_torch.distributed import ReplicaServer
    from repro_torch.models import model as M
    from repro_torch.serving.server import Server
    from repro_torch.sharding.specs import ShardCtx

    dp, _ = mesh_axes(args)
    if n > 1:                         # the host's cores, shared by the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    params = M.init_params(cfg, seed=args.seed, device=args.device)
    serve = serve_config(args, faults=args.faults,
                         sctx=None if group is None else ShardCtx(group=group),
                         ep_chunks=plan.ep_chunks)
    if dp > 1:
        server = ReplicaServer(cfg, params, dp, plan=plan, serve=serve, device=args.device)
    else:
        server = Server(cfg, params, plan, serve=serve, device=args.device)
    for r in requests:
        server.submit(r)
    report = server.run()
    if dp > 1:
        return report.merged, report.per_replica
    return report, None


def serve_mesh(args, cfg, plan, requests, dp: int, ep: int) -> None:
    """``--mesh DP,EP``: EP > 1 spawns EP rank processes on a gloo group
    (every rank serves every request; rank 0's report is printed after the
    ranks' tokens are checked to agree), else this process serves the DP
    replicas."""
    t0 = time.perf_counter()
    if ep > 1:
        from repro_torch.launch import mesh

        outs = mesh.spawn(mesh_rank, ep, (args, cfg, plan, requests))
        toks = [[r.tokens.tolist() for r in rep.request_results] for rep, _ in outs]
        if any(t != toks[0] for t in toks[1:]):
            raise SystemExit("expert-parallel ranks served different tokens")
        report, per_replica = outs[0]
    else:
        report, per_replica = mesh_rank(0, 1, None, args, cfg, plan, requests)
    gloo = " (gloo)" if ep > 1 else ""
    print(f"mesh: dp={dp} replicas x ep={ep} expert-parallel ranks{gloo}, "
          f"ep_chunks={plan.ep_chunks}, on {args.device}; served in "
          f"{time.perf_counter() - t0:.1f}s with weight initialisation")
    print_report(report, args)
    for i, r in enumerate(per_replica or []):
        print(f"replica[{i}]: {len(r.request_results)} requests, "
              f"{r.decode_throughput:.1f} decode tok/s, occupancy {r.occupancy:.0%}, "
              f"a2a {r.a2a_gb:.4f} GB")
    if report.collective_dispatches:
        print(f"expert-parallel: {report.a2a_gb:.4f} GB exchanged by all-to-all over "
              f"{report.collective_dispatches} collective MoE stages (ep={ep}, "
              f"chunks={plan.ep_chunks}), {report.clock_broadcasts} clock broadcasts")
    print_tokens(report)


if __name__ == "__main__":
    main()
