"""Rank bodies for ``tests/test_torch_distributed.py``.

Each function here runs in a process that ``repro_torch.launch.mesh.spawn``
starts, joined to a gloo group, on the CPU.  This module imports the port
only (no JAX), so a rank starts quickly; the test process holds the results
against the JAX package.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

CAPACITY_PRESSURE = 3      # per-expert capacity of the stage's drop case


def stage_inputs(cfg, T: int, seed: int = 0):
    """The stage cases' seeded f32 inputs, as numpy arrays (the test process
    feeds the same ones to the JAX stage)."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    a = {"x": rng.standard_normal((T, D)), "norm2": rng.uniform(0.5, 1.5, D),
         "router": rng.standard_normal((D, E)),
         "wg": rng.standard_normal((E, D, F)) * D ** -0.5,
         "wu": rng.standard_normal((E, D, F)) * D ** -0.5,
         "wd": rng.standard_normal((E, F, D)) * F ** -0.5}
    return {k: v.astype(np.float32) for k, v in a.items()}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


def stage_cases(cfg, rank: int, n: int, group, T: int):
    """The a2a stage (one chunk, two pipelined, two serial, and under
    capacity pressure) and the psum stage on the seeded inputs, each beside
    the port's single-device ``grouped_dispatch`` on the same inputs; then
    an engine's MoE stage at a batch that the group does not divide."""
    from repro_torch.core.engine import EngineStats
    from repro_torch.distributed import ep_engine as ep
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.specs import ShardCtx

    a = {k: torch.from_numpy(v) for k, v in stage_inputs(cfg, T).items()}
    e_loc = cfg.num_experts // n
    ws = [a[k][rank * e_loc:(rank + 1) * e_loc] for k in ("wg", "wu", "wd")]
    h = rms_norm(a["x"], a["norm2"], cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, a["router"], h)
    out = {}
    for cap in (T, CAPACITY_PRESSURE):
        out[f"single_{cap}"] = [_np(t) for t in moe_mod.grouped_dispatch(
            cfg, h, gates, idx, a["wg"], a["wu"], a["wd"], cap)]
    cases = {"a2a_1": ("a2a", 1, False, T), "a2a_2": ("a2a", 2, False, T),
             "a2a_2_serial": ("a2a", 2, True, T),
             "a2a_pressure": ("a2a", 1, False, CAPACITY_PRESSURE),
             "psum": ("psum", 1, False, T)}
    for name, (disp, chunks, serial, cap) in cases.items():
        sctx = ShardCtx(group=group, moe_dispatch=disp)
        st = EngineStats()
        if disp == "a2a":
            res = ep._ep_a2a_expert_module(cfg, sctx, chunks, cap, serial, a["norm2"],
                                           a["router"], *ws, a["x"], st)
        else:
            res = ep._ep_psum_expert_module(cfg, sctx, cap, a["norm2"], a["router"], *ws,
                                            a["x"], st)
        out[name] = [_np(t) for t in res] + [st.planned_reads]
    return out


def engine_fallback(cfg, params, plan, group, T: int):
    """An a2a engine's MoE stage at a batch of ``T`` rows that the group
    does not divide: the single-device stage's output, no bytes counted;
    and the construction check's error for experts the group does not
    divide."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.specs import ShardCtx

    eng = ModuleBatchingEngine(cfg, params, plan, device="cpu",
                               sctx=ShardCtx(group=group, moe_dispatch="a2a"))
    li = eng._moe_layers[0]
    p = params["layers"][li]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (T, cfg.d_model)).astype(np.float32))
    y = eng._expert_stage_grouped(li, p, x)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, p["moe"]["router"], h)
    want = moe_mod.grouped_dispatch(cfg, h, gates, idx, p["moe"]["experts_w_gate"],
                                    p["moe"]["experts_w_up"], p["moe"]["experts_w_down"],
                                    eng._expert_capacity(T))[0]
    from repro_torch.distributed.ep_engine import validate_ep_shard

    try:                              # experts the group does not divide
        validate_ep_shard(replace(cfg, num_experts=group.size() + 1), eng.sctx)
        error = None
    except ValueError as err:
        error = str(err)
    return {"equal": bool(torch.equal(y, want)), "a2a_bytes": eng.stats.a2a_bytes,
            "collective_dispatches": eng.stats.collective_dispatches, "error": error}


def serve(cfg, params, plan, requests, sched: str, sctx, chunks: int = 1,
          serial: bool = False, decode_len: int = 6, device="cpu"):
    """``requests`` through one ``Server`` with ``sctx``: its tokens and
    counters."""
    from repro_torch.serving.server import ServeConfig, Server

    server = Server(cfg, params, plan,
                    serve=ServeConfig(scheduler=sched, decode_len=decode_len, sctx=sctx,
                                      ep_chunks=chunks), device=device)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    server._engine.ep_serial = serial
    rep = server.run()
    st = server._engine.stats
    return {"tokens": [r.tokens.tolist() for r in rep.request_results],
            "a2a_bytes": rep.a2a_bytes, "collective_dispatches": rep.collective_dispatches,
            "clock_broadcasts": rep.clock_broadcasts, "planned_reads": st.planned_reads,
            "decode_slot_steps": rep.decode_slot_steps, "fused_ticks": st.fused_ticks,
            "dropped": rep.expert_tokens_dropped,
            "waves": [list(w) for w in rep.admission_waves],
            "expert_load": _np(rep.expert_load)}


def serve_rank(rank: int, n: int, group, cfg, np_params, plan, prompts, decode_len: int,
               stage_T: int, timed):
    """Everything one world size checks, in one spawn: the stage cases, the
    engine fallback, a whole ``Server`` under both schedulers at one and two
    pipeline chunks, one serial run, one psum run, one strict-sanitizer run
    and one run with timed arrivals."""
    from repro_torch import analysis
    from repro_torch.bridge import from_numpy_params
    from repro_torch.serving.server import Request
    from repro_torch.sharding.specs import ShardCtx

    torch.set_num_threads(2)
    params = from_numpy_params(cfg, np_params, "cpu")
    out = {"stage": stage_cases(cfg, rank, n, group, stage_T),
           "fallback": engine_fallback(cfg, params, plan, group, n + 1)}
    reqs = [Request(np.asarray(p, np.int32), decode_len) for p in prompts]
    a2a = ShardCtx(group=group, moe_dispatch="a2a")
    for sched in ("static", "continuous"):
        for chunks in (1, 2):
            out[f"{sched}_{chunks}"] = serve(cfg, params, plan, reqs, sched, a2a, chunks)
    out["static_2_serial"] = serve(cfg, params, plan, reqs, "static", a2a, 2, serial=True)
    out["psum"] = serve(cfg, params, plan, reqs, "static",
                         ShardCtx(group=group, moe_dispatch="psum"))
    with analysis.sanitize(strict=True) as san:
        out["strict"] = serve(cfg, params, plan, reqs, "static", a2a, 2)
    out["strict_planned"] = san.report()["planned_transfers"]
    treqs = [replace(r, arrival_s=t) for r, t in zip(reqs, timed)]
    out["timed"] = serve(cfg, params, plan, treqs, "continuous", a2a, 1)
    return out


def cuda_ep_rank(rank: int, n: int, group, num_layers: int, prompts, decode_len: int):
    """A rank of ``tests/test_torch_cuda.py``'s expert-parallel checks, on the
    card: OLMoE smoke (bf16) at ``num_layers`` layers, seeded weights; the
    tokens of a static serve at two pipeline chunks, then one decode step
    of a fresh server under ``set_sync_debug_mode("error")`` and the strict
    sanitizer: its planned reads by tag."""
    from repro_torch import analysis
    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.models import model as M
    from repro_torch.serving.server import Request, ServeConfig, Server
    from repro_torch.sharding.specs import ShardCtx

    cfg = replace(get_config("olmoe-1b-7b", smoke=True), num_layers=num_layers)
    params = M.init_params(cfg, seed=0, device="cuda")
    B = len(prompts)
    plan = Plan(B=B, b_a=B // 2, b_e=B, omega=0.0, decode_chunk=8)
    reqs = [Request(np.asarray(p, np.int32), decode_len) for p in prompts]
    sctx = ShardCtx(group=group)
    out = serve(cfg, params, plan, reqs, "static", sctx, 2, decode_len=decode_len,
                device="cuda")
    server = Server(cfg, params, plan, device="cuda", serve=ServeConfig(
        decode_len=decode_len, sctx=sctx, ep_chunks=2))
    for r in reqs:
        server.submit(r)
    server.step()                     # admission, prefill and the first tick
    torch.cuda.synchronize()
    with analysis.sanitize(strict=True) as san:
        torch.cuda.set_sync_debug_mode("error")
        try:
            server.step()             # one decode tick
        finally:
            torch.cuda.set_sync_debug_mode(0)
    out["step_planned"] = san.report()["planned_transfers"]
    out["step_host_reads"] = san.report()["host_reads"]
    return out
