"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero with its traceback):

1. device   -- require CUDA; print the card's name and power limit;
2. build    -- compile every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels  -- hold each kernel to its plain PyTorch version on the card at
               the main path's shapes (and time kernel, plain version and the
               closest single PyTorch library call);
4. serve    -- the port's ``Server`` on full-width, full-depth OLMoE-1B-7B
               (bf16, seeded random weights, all resident, omega = 0): 64
               ragged requests, static then continuous; the kernels' launch
               counts are read around this phase;
5. parity   -- the same engine at full width but 2 layers, f32: card
               (kernels) against CPU (plain versions).

``--phases kernels,serve,parity,profile`` adds a torch.profiler breakdown of
the server's decode tick and of one prefill wave of the served prompts (not
part of the default run).

The last two lines of standard output are the card's ``nvidia-smi`` name and
power limit, then ``{"ok": true, "device": {...}}``.  ``--phases`` runs a
subset (for debugging); the default runs all.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BW = 3.35e12         # H100 SXM HBM3 bytes/s
# Tolerances.  f32: tests/test_kernels.py's TOL, 2e-5 absolute, on outputs
# of order 0.1.  bf16: that file's 0.05 is absolute on unscaled inputs whose
# outputs grow with depth; the inputs here are at the models' scale (outputs
# of order 0.05), where 0.05 would pass a kernel that writes zeros.  So each
# output row (an expert's row of h or y, one head's attention output) must
# stay within 0.02 of that row's largest reference value: one bf16 rounding
# flip is at most 2**-7 (0.0078) of it, and a dead capacity row (all zero in
# the reference) must be exactly zero.
TOL_F32 = 2e-5
REL_BF16 = 0.02
REPLACES = {
    "expert_gate_up": "src/repro/kernels/expert_gemm.py:124",
    "grouped_matmul": "src/repro/kernels/expert_gemm.py:64",
    "decode_attention": "src/repro/kernels/decode_attention.py:77",
}
SOURCE = {
    "expert_gate_up": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events.  A sleep kernel
    holds the stream while the host queues all ``iters`` calls, so the
    events time the kernels back to back and not the Python that launches
    them (which dominates a kernel of a few microseconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)           # ~0.1 s at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float):
    t_b, t_o = nbytes / PEAK_BW, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def errors(got, want):
    """(largest absolute error, largest error of a row of the last axis over
    that row's largest |reference| value)."""
    d = (got.float() - want.float()).abs()
    peak = want.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float(d.max()), float((d.amax(-1) / peak).max())


def tolerance(dtype) -> dict:
    if dtype == torch.float32:
        return {"abs": TOL_F32}
    return {"rel_per_row": REL_BF16}


def within(err, tol: dict) -> bool:
    abs_err, rel_err = err
    return abs_err < tol["abs"] if "abs" in tol else rel_err < tol["rel_per_row"]


def host_ms(fn) -> float:
    """Host wall milliseconds of ``fn`` with the device drained after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sync_sites(fn):
    """Python lines (file:line) where ``fn`` made the host wait for the
    device, from PyTorch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def profile_region(fn, top: int = 12):
    """Run ``fn`` under torch.profiler: device-busy ms (sum of kernel times
    on the one stream) and the kernels that took the most device time.
    Returns (summary, fn())."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue                         # host-side op, not a kernel
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    return ({"device_busy_ms": sum(r[0] for r in rows),
             "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                     for ms, k, n in rows[:top]]}, out)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def routed_counts(gen, E: int, k: int, T: int, C: int, dev) -> torch.Tensor:
    """Per-expert routed counts of T tokens each picking k distinct experts
    uniformly, clamped to capacity C (int32 on the device)."""
    picks = torch.rand((T, E), generator=gen, device=dev).argsort(dim=1)[:, :k]
    load = torch.bincount(picks.reshape(-1), minlength=E)
    return torch.clamp(load, max=C).to(torch.int32)


def ffn_inputs(gen, E, C, D, F, dtype, dev, counts=None):
    x = torch.randn((E, C, D), generator=gen, device=dev) * 0.3
    if counts is not None:                     # dispatch leaves dead rows zero
        live = torch.arange(C, device=dev)[None, :] < counts[:, None]
        x = x * live[..., None]
    # weights at the models' dense_init scale (in_dim ** -0.5), so outputs
    # keep the same scale at every width
    wg = torch.randn((E, D, F), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((E, D, F), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((E, F, D), generator=gen, device=dev) * F ** -0.5
    return [t.to(dtype) for t in (x, wg, wu, wd)]


def check_ffn(name, gen, E, C, D, F, dtype, dev, counts=None, timing=False):
    from repro_torch.kernels import ops, ref

    x, wg, wu, wd = ffn_inputs(gen, E, C, D, F, dtype, dev, counts)
    got = ops.grouped_expert_ffn(x, wg, wu, wd, counts)
    want = ref.expert_ffn_ref(x, wg, wu, wd, counts)
    h = ops.expert_gate_up(x, wg, wu, counts)
    h_ref = ref.expert_gate_up_ref(x, wg, wu, counts)
    down = ops.grouped_matmul(h_ref, wd, counts)
    down_ref = ref.grouped_matmul_ref(h_ref, wd, counts)
    torch.cuda.synchronize()
    tol = tolerance(dtype)
    errs = {"ffn": errors(got, want), "gate_up": errors(h, h_ref),
            "grouped_matmul": errors(down, down_ref)}
    peaks = {"ffn": want, "gate_up": h_ref, "grouped_matmul": down_ref}
    case = {"case": name, "E": E, "C": C, "D": D, "F": F,
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": {k: e[0] for k, e in errs.items()},
            "rel_err": {k: e[1] for k, e in errs.items()},
            "ref_peak": {k: float(t.float().abs().max()) for k, t in peaks.items()},
            "tolerance": tol}
    emit(case)
    for key, err in errs.items():
        if not within(err, tol):
            raise AssertionError(f"{name}: {key} error {err} outside {tol}")
    if not timing:
        return case, None
    es = x.element_size()
    n_live = int(counts.sum()) if counts is not None else E * C
    e_live = int((counts > 0).sum()) if counts is not None else E
    bf = dtype == torch.bfloat16
    peak = PEAK_BF16 if bf else PEAK_F32
    # K1: live experts' wg+wu, live x rows read once; all of h written
    k1_bytes = e_live * 2 * D * F * es + n_live * D * es + E * C * F * es
    k1_flops = 4.0 * n_live * D * F
    k2_bytes = e_live * F * D * es + n_live * F * es + E * C * D * es
    k2_flops = 2.0 * n_live * F * D

    def lib_gate_up():
        return torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)

    rows = []
    for kname, kern, plain, lib, nbytes, flops, err in (
        ("expert_gate_up", lambda: ops.expert_gate_up(x, wg, wu, counts),
         lambda: ref.expert_gate_up_ref(x, wg, wu, counts), lib_gate_up,
         k1_bytes, k1_flops, errs["gate_up"]),
        ("grouped_matmul", lambda: ops.grouped_matmul(h_ref, wd, counts),
         lambda: ref.grouped_matmul_ref(h_ref, wd, counts),
         lambda: torch.bmm(h_ref, wd), k2_bytes, k2_flops,
         errs["grouped_matmul"]),
    ):
        b_ms, b_by = bound(nbytes, flops, peak)
        rows.append({
            "name": kname, "case": name, "max_abs_err": err[0],
            "rel_err": err[1], "tolerance": tol,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
        })
    return case, rows


def attn_inputs(gen, B, H, K, hd, S, dtype, dev, pos):
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, pos


def check_attention(name, gen, B, H, K, hd, S, dtype, dev, timing=False):
    from repro_torch.kernels import ops, ref

    pos = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    q, k, v, pos = attn_inputs(gen, B, H, K, hd, S, dtype, dev, pos)
    got = ops.decode_attention(q, k, v, pos)
    want = ref.decode_attention_ref(q, k, v, pos)
    # poisoned slots past pos must not change the output
    idx = torch.arange(S, device=dev)[None, :, None, None]
    dead = idx > pos[:, None, None, None]
    k2 = torch.where(dead, torch.full_like(k, 1e4), k)
    v2 = torch.where(dead, torch.full_like(v, -1e4), v)
    poisoned = ops.decode_attention(q, k2, v2, pos)
    torch.cuda.synchronize()
    err, err_p = errors(got, want), errors(got, poisoned)[0]
    tol = tolerance(dtype)
    emit({"case": name, "B": B, "H": H, "K": K, "hd": hd, "S": S,
          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err[0],
          "rel_err": err[1], "ref_peak": float(want.float().abs().max()),
          "poisoned_diff": err_p, "tolerance": tol})
    if not within(err, tol):
        raise AssertionError(f"{name}: error {err} outside {tol}")
    if not err_p < 1e-5:
        raise AssertionError(f"{name}: poisoned slots changed the output by {err_p}")
    if not timing:
        return None
    es = q.element_size()
    n_valid = int(torch.clamp(pos.long() + 1, max=S).sum())
    nbytes = 2 * n_valid * K * hd * es + 2 * B * H * hd * es + B * 4
    flops = 4.0 * n_valid * H * hd
    b_ms, b_by = bound(nbytes, flops,
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    # library yardstick: SDPA with a boolean mask over (B, H, 1, S)
    qs = q[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=H != K)

    return {
        "name": "decode_attention", "case": name, "max_abs_err": err[0],
        "rel_err": err[1], "tolerance": tol, "ms": time_ms(lambda: ops.decode_attention(q, k, v, pos)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, pos)),
        "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
    }


def phase_kernels(dev, plan, span: int, prompt_len: int):
    """The serve phase's shapes: decode capacity min(b_e, B), prefill
    capacity next_pow2(max expert load) of a b_a x prompt_len micro-batch
    (the engine's probe), attention over b_a rows of a span-slot cache."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    E, D, F, k = 64, 2048, 1024, 8
    rows = []
    decode_c = min(plan.b_e, plan.B)
    counts = routed_counts(gen, E, k, plan.B, decode_c, dev)
    _, r = check_ffn("olmoe-decode", gen, E, decode_c, D, F, bf, dev, counts,
                     timing=True)
    rows += r
    tokens = plan.b_a * prompt_len
    load = routed_counts(gen, E, k, tokens, tokens, dev)
    prefill_c = 1 << int(load.max() - 1).bit_length()
    _, r = check_ffn("olmoe-prefill", gen, E, prefill_c, D, F, bf, dev, load,
                     timing=True)
    rows += r
    check_ffn("olmoe-decode-f32", gen, E, decode_c, D, F, f32, dev, counts)
    # the planner's own capacity at B = 64 (balanced load, no headroom)
    check_ffn("olmoe-decode-C8", gen, E, 8, D, F, bf, dev,
              torch.clamp(counts, max=8))
    check_ffn("olmoe-ragged-C", gen, E, 100, D, F, bf, dev)
    check_ffn("ragged-N-f32", gen, 3, 70, 256, 200, f32, dev)
    check_ffn("mixtral-expert", gen, 8, 64, 4096, 14336, bf, dev)
    rows.append(check_attention("olmoe-decode", gen, plan.b_a, 16, 16, 128, span,
                                bf, dev, timing=True))
    check_attention("olmoe-B64-S512", gen, 64, 16, 16, 128, 512, bf, dev)
    check_attention("olmoe-B64-S512-f32", gen, 64, 16, 16, 128, 512, f32, dev)
    check_attention("gqa-32-8", gen, 64, 32, 8, 128, 512, bf, dev)
    check_attention("gqa-32-8-f32", gen, 8, 32, 8, 128, 512, f32, dev)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: full-width serving through the port's Server
# ---------------------------------------------------------------------------
def serve_setup(n_requests: int = 64, decode_len: int = 32):
    """The served cell: full OLMoE-1B-7B, ragged prompts 64..256, the
    planner's plan on the H100 profile with b_e raised to B (one expert can
    take every token of a step, so no copy drops and both schedulers must
    give identical tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM_80GB
    from repro_torch.launch.serve import build_plan

    cfg = get_config("olmoe-1b-7b")
    lens = [64 + (192 * i) // (n_requests - 1) for i in range(n_requests)]
    args = argparse.Namespace(prompt_lens=lens, decode_len=decode_len,
                              scheduler="static", batch=n_requests,
                              requests=n_requests, b_e=n_requests)
    return cfg, build_plan(cfg, H100_SXM_80GB, args), lens, decode_len


def phase_serve(dev, setup, profile=False):
    import numpy as np

    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.server import ServeConfig, Server
    from repro_torch.serving.weights import tree_bytes

    cfg, plan, lens, decode_len = setup
    n_requests = len(lens)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "serve", "init_s": time.perf_counter() - t0,
          "weights_gb": tree_bytes(params) / 1e9})
    requests = synthetic_requests(
        DatasetSpec("smoke", n_requests, max(lens), decode_len),
        cfg.vocab_size, seed=0, prompt_lens=lens)
    # warm-up pass (cuBLAS handles, allocator, kernel libraries) so both
    # timed schedulers run warm; its launches are not counted
    warm = Server(cfg, params, plan, serve=ServeConfig(decode_len=2), device=dev)
    for r in requests[:2]:
        warm.submit(r)
    warm.run()
    del warm
    tokens, reports, counts = {}, {}, {}
    for sched in ("static", "continuous"):
        server = Server(cfg, params, plan,
                        serve=ServeConfig(scheduler=sched, decode_len=decode_len),
                        device=dev)
        for r in requests:
            server.submit(r)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[sched] = ops.launch_counts()
        reports[sched] = rep
        tokens[sched] = [r.tokens for r in rep.request_results]
        emit({"phase": "serve", "scheduler": sched, "wall_s": wall,
              "prefill_tokens": rep.prefill_tokens, "prefill_s": rep.prefill_s,
              "prefill_tok_s": rep.prefill_throughput,
              "decode_tokens": rep.decode_tokens, "decode_s": rep.decode_s,
              "decode_tok_s": rep.decode_throughput,
              "dropped": rep.expert_tokens_dropped,
              "decode_slot_steps": rep.decode_slot_steps,
              "launches": counts[sched]})
        if dev.type == "cuda" and not all(v > 0 for v in counts[sched].values()):
            raise AssertionError(f"{sched}: a kernel was never launched: {counts[sched]}")
        if len(rep.request_results) != n_requests or any(
                r.tokens.size != decode_len for r in rep.request_results):
            raise AssertionError(f"{sched}: wrong number of tokens served")
        del server
    same = all(np.array_equal(a, b)
               for a, b in zip(tokens["static"], tokens["continuous"]))
    if not same:
        raise AssertionError("static and continuous schedulers gave different tokens")
    flat = np.concatenate(tokens["static"])
    if flat.min() < 0 or flat.max() >= cfg.vocab_size:
        raise AssertionError("token ids out of range")
    # where the time goes in a served decode tick: the server's own tick (one
    # per-module decode_chunk tick, then one device-to-host read of the
    # tokens), from the served prompts' own positions, on a fresh engine
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.sampling import BatchSampler

    tick_ms = {s: rep.decode_s * 1e3 / (rep.decode_slot_steps / plan.B)
               for s, rep in reports.items()}
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max(lens) + decode_len,
                               device=dev)
    lengths = np.array([len(r.prompt) for r in requests], np.int64)
    prompts = np.zeros((n_requests, int(lengths.max())), np.int64)
    for i, r in enumerate(requests):
        prompts[i, :lengths[i]] = r.prompt
    sampler = BatchSampler.uniform(n_requests, None)
    lg = eng.prefill(prompts, lengths=lengths)
    tok0 = sampler.sample(lg)
    steps = 4

    def decode_ticks():
        tok = tok0
        for t in range(steps):
            tok = eng.decode_chunk(tok, lengths + t, sampler, 1)[:, 0]
            tok.cpu()
        return tok

    decode_ticks()                                          # warm
    wall = host_ms(decode_ticks) / steps
    lg2 = eng.decode_step(tok0, lengths)
    if not (torch.isfinite(lg).all() and torch.isfinite(lg2).all()):
        raise AssertionError("non-finite logits")
    emit({"phase": "decode_tick", "B": n_requests, "wall_ms_per_tick": wall,
          "server_ms_per_tick": tick_ms})
    if profile:
        # device busy from the profiler; walls from unprofiled runs
        prof, _ = profile_region(decode_ticks)
        busy = prof["device_busy_ms"] / steps
        emit({"phase": "profile", "what": f"decode tick B={n_requests}, per tick",
              "wall_ms": wall, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall,
              "idle_share_vs_server": {s: 1.0 - busy / ms for s, ms in tick_ms.items()},
              "sync_sites": sync_sites(decode_ticks),
              "top_over_steps": prof["top"]})
        wall_p = host_ms(lambda: eng.prefill(prompts, lengths=lengths))
        prof, _ = profile_region(lambda: eng.prefill(prompts, lengths=lengths))
        emit({"phase": "profile",
              "what": f"prefill of the {n_requests} served prompts, one wave",
              "wall_ms": wall_p, "device_busy_ms": prof["device_busy_ms"],
              "idle_share": 1.0 - prof["device_busy_ms"] / wall_p,
              "server_prefill_ms": {s: rep.prefill_s * 1e3 for s, rep in reports.items()},
              "top": prof["top"]})
    del eng, params
    torch.cuda.empty_cache()
    return counts["static"], reports


# ---------------------------------------------------------------------------
# Phase 5: full width, 2 layers, f32: card against CPU
# ---------------------------------------------------------------------------
def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def phase_parity(dev):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import model as M

    cfg = replace(get_config("olmoe-1b-7b"), num_layers=2, dtype="float32")
    params = M.init_params(cfg, seed=1, device=dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    plan = Plan(B=4, b_a=4, b_e=4, omega=0.0)
    out = {}
    for where, p in (("cuda", params), ("cpu", _to_cpu(params))):
        eng = ModuleBatchingEngine(cfg, p, plan, max_seq=40, device=where)
        lg = [eng.prefill(prompts).float().cpu()]
        toks = [lg[0].argmax(-1)]
        for t in range(3):
            lg.append(eng.decode_step(toks[-1], 32 + t).float().cpu())
            toks.append(lg[-1].argmax(-1))
        out[where] = (lg, toks)
    scale = float(out["cpu"][0][0].abs().max())
    errs = [float((a - b).abs().max()) / scale
            for a, b in zip(out["cuda"][0], out["cpu"][0])]
    same = all(torch.equal(a, b) for a, b in zip(out["cuda"][1], out["cpu"][1]))
    emit({"phase": "parity", "rel_err_per_step": errs, "tolerance": 1e-3,
          "tokens_match": same})
    if not (max(errs) < 1e-3 and same):
        raise AssertionError(f"card vs CPU: errors {errs}, tokens match {same}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,serve,parity")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name, line = torch.cuda.get_device_name(0), gpu_line()
    emit({"phase": "device", "name": name, "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t_build = build.build_all()
    emit({"phase": "build", "seconds": t_build,
          "ptxas": {n: build.ptxas_log(n).strip().splitlines()[-6:]
                    for n in build.SOURCES}})
    setup = serve_setup()
    _, plan, lens, decode_len = setup
    rows = []
    if "kernels" in phases:
        rows = phase_kernels(dev, plan, span=max(lens) + decode_len,
                             prompt_len=max(lens))
        emit({"kernel_cases": rows})
    launches = None
    if "serve" in phases:
        launches, _ = phase_serve(dev, setup, profile="profile" in phases)
    if "parity" in phases:
        phase_parity(dev)
    if rows:
        seen, line_rows = set(), []
        for r in rows:                      # one entry per kernel: decode shape
            if r["name"] in seen:
                continue
            seen.add(r["name"])
            line_rows.append({
                "name": r["name"], "route": "cuda", "source": SOURCE[r["name"]],
                "replaces": REPLACES[r["name"]],
                "launches": None if launches is None else launches[r["name"]],
                "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
                "tolerance": r["tolerance"],
                "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "case": r["case"],
            })
        emit({"kernels": line_rows})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
