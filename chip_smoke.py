"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero with its traceback):

1. device   -- require CUDA; print the card's name and power limit;
2. build    -- compile every kernel of ``src/repro_torch/kernels/csrc``;
3. kernels  -- hold each kernel to its plain PyTorch version on the card at
               the main path's shapes (and time kernel, plain version and the
               closest single PyTorch library call);
4. serve    -- the port's ``Server`` on full-width, full-depth OLMoE-1B-7B
               (bf16, seeded random weights, all resident, omega = 0, the
               planner's b_a): 64 ragged requests, static then continuous;
               the kernels' launch counts are read around each run; then
               16 requests with mixed greedy / temperature / top-k
               sampling against the per-module oracle; then the same 64
               requests with online capacity re-planning (``replan_skew``,
               one tick a step): static, continuous and the per-module
               oracle re-plan alike and give the same tokens;
5. serve_long -- the same server and weights on 32 long prompts (1024..3584
               tokens, decode 64, max_seq 3648): prefill through K4 at every
               layer, decode through K3 at spans up to 3648; its own launch
               counts;
6. serve_ssm -- the server on full-width, full-depth Mamba2-370M (bf16,
               seeded, the planner's b_a): 128 prompts of 200..1800 tokens,
               decode 64, both schedulers; prefill through K5 at every layer,
               decode through the plain recurrent step;
   serve_omega -- serve's requests and weights at omega 0.5: rows 0-31
               attend on the host CPU (the paper's §B mechanism), rows
               32-63 replay the fused graph; static, continuous and the
               per-module oracle give identical tokens, the host split and
               the planned reads are as reckoned;
   serve_paged -- serve_long's requests with the KV in 128-slot pages and
               7.5 GB of device frames: 481 of 928 frames page-locked on the
               host, streamed a layer ahead and read in place by K3p; the
               tokens bit-identical to serve_long's contiguous ones under
               both schedulers, then Mode A (no cap) on the fused graph;
   serve_faults -- serve_streamed's requests with injected copy failures and
               stalls, then serve_paged's Mode B requests with injected page
               OOMs (2a) and OOMs plus preemptions and a midway demotion
               (2b), all under the strict sanitizer with the pointer check:
               tokens equal the fault-free ones (2a and 2b equal to a
               fault-free witness admitted in the waves the OOMs split, in
               Mode B and in the contiguous cache), every injected kind
               recovered; then the sanitizer's cost per tick;
   serve_prefix -- 64 requests of one 1024-token shared instruction plus a
               16..128-token question, B 32, 128-token pages: a wave of 32
               misses, then 32 prefix hits (the stored prefix copied in,
               the suffix prefilled through K4 with a query offset); cold
               and with the prefix cache under both schedulers, the
               per-module oracle and Mode B, all with the same tokens;
   oracles  -- the engine's reference oracles on serve's weights (16
               requests of 64..256 tokens, decode 16, B = b_e = 16), then on
               the same seed's f32 weights: the loop expert path against the
               per-module grouped server (first tokens, the first decode
               tick's logits on the rows both routed alike, launch counts,
               no unplanned host sync), the exact (dense-combine) prefill
               against the grouped one (logits, capacity probes), and
               greedy_generate (model-based batching) beside the per-module
               engine on 16 prompts of 256 tokens;
   train    -- OLMoE-1B-7B at full width and 8 layers, bf16: 12 AdamW steps
               with remat on one seeded 4 x 512 batch (the loss must fall by
               0.2), a checkpoint round trip, remat off / full / dots at 2
               layers, one f32 smoke step against the CPU; no kernel
               launched, the memory freed;
7. parity   -- card (kernels) against CPU (plain versions), f32: OLMoE at
               full width but 2 layers (32 tokens, a ragged 1536-token
               prompt), Mamba2 at full width but 2 layers (600 and 300
               tokens), and the Jamba smoke config (one interleave period,
               lengths 100 and 77), which runs K1-K5 in one model; OLMoE at
               2 layers with omega 0.5 and every KV frame on the host, an
               OLMoE prefix hit (640 + 77 tokens) at 2 layers, and
               musicgen-medium at 2 layers with 256 frontend frames + 44
               tokens;
8. profile  -- (inside phases 4-6) torch.profiler over each path's decode
               chunk and one prefill wave.

Every served decode tick is a replay of the engine's CUDA graph of the
fused tick (one token read per chunk).  Each serve phase fails unless every
decode tick of both schedulers was a replay, the kernels' launch counts --
replays add the launches their capture recorded -- equal those of the
per-module oracle (``fused_decode=False``, eager launches) on the same
requests, and the oracle's tokens equal both schedulers'.  The serve phase
adds a sampled run: mixed greedy, temperature and top-k requests, the fused
server against the per-module oracle, identical tokens.

After each serve phase a fresh engine prefills the same prompts and runs a
few decode ticks with the kernels' largest calls captured (on the eager
per-module path: a graph capture records and does not run), and every
kernel is held to its plain version on those inputs (the path's own shapes:
the prefill capacity buffer, K4's and K5's micro-batch, a decode tick's FFN
and K3).  The ``profile`` phase (in the default run) adds a torch.profiler
breakdown of one chunk of replayed ticks -- the kernels the device ran in
it, checked against the replay accounting -- and of one prefill wave, and
fails on any host sync inside the decode chunk.  Every server is deleted
without a ``gc.collect()``, and ``torch.cuda.memory_allocated()`` must fall
back to what it was before the server was built, its graphs included.

The last two lines of standard output are the card's ``nvidia-smi`` name and
power limit, then ``{"ok": true, "device": {...}}``.  ``--phases`` runs a
subset (for debugging); the default runs all.
"""
from __future__ import annotations

import argparse
import contextlib
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
# K5 (the SSD scan): y in f32 within tests/test_kernels.py's 4 x TOL for
# this kernel; y in bf16 per row as above; the f32 state within 1e-4 of its
# (row, head) slice's largest value (the state update stays in f32).
TOL_SSD_F32 = 8e-5
REL_SSD_STATE = 1e-4
REPLACES = {
    "expert_gate_up": "src/repro/kernels/expert_gemm.py:124",
    "grouped_matmul": "src/repro/kernels/expert_gemm.py:64",
    "decode_attention": "src/repro/kernels/decode_attention.py:77",
    "flash_attention": "src/repro/kernels/flash_attention.py:80",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:85",
    # K3p has no Pallas counterpart: the reference's paged decode gathers the
    # frames with XLA (src/repro/core/engine.py:388) and then runs K3's
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:77",
}
SOURCE = {
    "expert_gate_up": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "decode_attention_paged": "src/repro_torch/kernels/csrc/decode_attention.cu",
}
# the kernels each served path must launch
PATH_KERNELS = {
    "serve": ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention"),
    "serve_long": ("expert_gate_up", "grouped_matmul", "decode_attention",
                   "flash_attention"),
    "serve_ssm": ("ssd_scan",),
    "serve_streamed": ("expert_gate_up", "grouped_matmul", "decode_attention",
                       "flash_attention"),
    "serve_mixtral": ("expert_gate_up", "grouped_matmul", "decode_attention",
                      "flash_attention"),
    "serve_omega": ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention"),
    "serve_paged": ("expert_gate_up", "grouped_matmul", "decode_attention_paged",
                    "flash_attention"),
    "serve_replicas": ("expert_gate_up", "grouped_matmul", "decode_attention",
                       "flash_attention"),
    "serve_ep": ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention"),
}
# every launch of a served (bf16, full-size) path must take these designs
NEW_DESIGNS = (("expert_gate_up", "wgmma"), ("grouped_matmul", "wgmma"),
               ("decode_attention", "split"), ("flash_attention", "wgmma"),
               ("ssd_scan", "mma"), ("decode_attention_paged", "split"))
# the long-prompt path: 32 prompts even-spread over 1024..3584, decode 64
# (max_seq 3648, within OLMoE's 4096 context), at the planner's b_a
LONG_REQUESTS, LONG_MIN, LONG_MAX, LONG_DECODE = 32, 1024, 3584, 64
# the SSM path: 128 prompts even-spread over 200..1800 on Mamba2-370M, decode
# 64 (max_seq 1864, within its 2048-token training context)
SSM_ARCH, SSM_REQUESTS, SSM_MIN, SSM_MAX, SSM_DECODE = "mamba2-370m", 128, 200, 1800, 64
# the host-attention path: serve's 64 requests at omega 0.5 (rows 0-31 attend
# on the host CPU), b_a 32
OMEGA, OMEGA_B_A = 0.5, 32
# the paged path: serve_long's requests, KV in 128-slot pages, 7.5 GB of
# device frames (447 of the 928 frames; the other 481 page-locked on the host)
PAGE_TOKENS, DEVICE_KV_GB = 128, 7.5
# the prefix-cache path: one seeded 1024-token shared instruction in front of
# each request's own 16..128-token question (prompts 1040..1152, every key at
# pspan 1024), decode 32, a wave of misses then a wave of hits
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_DECODE, PREFIX_MAX_SEQ = 1024, 64, 32, 1280
PREFIX_QUESTIONS = (16, 128)
PREFIX_SUFFIXES = (16, 64, 128)
# online capacity re-planning on serve's requests: the drift (absolute share
# of the hottest expert between checks) above which b_e is re-planned
REPLAN_SKEW = 1e-6
# the oracles path: serve's weights, 16 requests of 64..256 tokens, decode 16,
# B = b_e = 16; greedy_generate on 16 prompts of 256 tokens
ORACLE_REQUESTS, ORACLE_DECODE, ORACLE_PROMPT = 16, 16, 256
# the oracles' f32 logit tolerance: parity's 1e-3, per row against its peak
TOL_ORACLE_F32 = 1e-3
# training: OLMoE-1B-7B at full width and 8 of its 16 layers (all 16 with
# grads and f32 AdamW moments would need ~83 GB), bf16, one seeded batch of
# 4 x 512 tokens, 12 steps; the card-vs-CPU step on the Jamba smoke config
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = (
    "olmoe-1b-7b", 8, 4, 512, 12, 1e-4)
TRAIN_PARITY_ARCH = "jamba-1.5-large-398b"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """``name<ints..., type>`` of a mangled kernel template instantiation."""
    import re

    end = mangled.find("_kernelI") + len("_kernel")
    if end < len("_kernel"):
        return mangled[-60:]
    name = mangled[:end]
    for k in range(end - 1, 0, -1):             # the length-prefixed identifier
        j = k
        while j > 0 and mangled[j - 1].isdigit():
            j -= 1
        if any(int(mangled[i:k]) == end - k for i in range(j, k)):
            name = mangled[k:end]
            break
    tmpl = mangled[end:]
    args = re.findall(r"Li(\d+)E", tmpl) + (["bf16"] if "bfloat16" in tmpl else [])
    return f"{name}<{','.join(args)}>"


def ptxas_summary(log: str) -> list:
    """Registers and spill bytes of each kernel instantiation, from
    ``nvcc -Xptxas -v``'s log: [[function, registers, spill store bytes]],
    then ptxas's performance warnings (a serialised wgmma chain, an ignored
    setmaxnreg) as [function, warning code]."""
    out, warn, fn, spill = [], [], None, 0
    for line in log.splitlines():
        if "Potential Performance Loss" in line:
            code = line.split("(")[1].split(")")[0] if "(" in line else "?"
            warn.append([_kernel_name(line.split("'")[1]) if "'" in line else "?", code])
        elif "Compiling entry function" in line:
            fn, spill = _kernel_name(line.split("'")[1]), 0
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and fn is not None:
            out.append([fn, int(line.split("Used")[1].split()[0]), spill])
            fn = None
    return out + [["warning"] + w for w in warn]


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
    that row's largest |reference| value), over slices of the first axis so
    that the f32 copies of a prefill-sized buffer stay small."""
    n = max(1, (1 << 28) // max(1, got[0].numel()))
    abs_err = rel_err = 0.0
    for lo in range(0, got.shape[0], n):
        w = want[lo:lo + n].float()
        d = (got[lo:lo + n].float() - w).abs()
        peak = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d.amax(-1) / peak).max()))
    return abs_err, rel_err


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


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` (a kernel wrapper) spends before
    it returns, over ``calls`` calls queued without a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


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
    for w in caught:                  # (not the mode's own "prototype" notice)
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


RANGES = ("ssm_decode",)     # profiler ranges whose device time is read


# host calls that queue device work: a launch (of a kernel or a graph), a
# copy, a fill; each leaves one device record or more of its correlation
ENQUEUES = ("Launch", "Memcpy", "Memset")
TRACE_ATTEMPTS = 5


def trace_events(prof) -> list:
    """The events of a finished torch.profiler run, from its Chrome trace."""
    path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    return events


def lost_device_records(events) -> dict:
    """Host calls in the trace that queued device work and have no device
    record of their correlation, by call name: records the profiler dropped.
    On the H100 a trace begun with the profiler (no warm-up) lost the device
    records of its first few launches and copies in most regions, and a
    cluster elsewhere now and then; with the warm-up, about one trace in
    ten of a decode chunk loses the records of the two copies and launches
    around its graph replays (its first two or its last two host calls).  A
    lost record of a weight copy fails a check that holds the trace's copies
    to the bytes the store queued, with no fault in the port."""
    queued, seen = {}, set()
    for ev in events:
        cat, corr = ev.get("cat", ""), ev.get("args", {}).get("correlation")
        if corr is None:
            continue
        if cat in ("cuda_runtime", "cuda_driver") and any(k in ev.get("name", "")
                                                          for k in ENQUEUES):
            queued[corr] = ev["name"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            seen.add(corr)
    lost = {}
    for corr, name in queued.items():
        if corr not in seen:
            lost[name] = lost.get(name, 0) + 1
    return lost


def profiled(fn, what: str, prepare=None):
    """``fn()`` under torch.profiler (host and device) after one traced
    warm-up run of ``fn`` whose events are dropped (the profiler's
    ``warmup`` step: device tracing is on before the recorded run starts),
    with a device sync after each run, until the trace is complete: every
    host call that queued device work has its device record
    (``lost_device_records``).  An incomplete trace is printed and ``fn``
    profiled again, at most ``TRACE_ATTEMPTS`` times in all, then the phase
    fails: a check is never made on a trace that lost records.
    ``prepare()`` runs between the warm-up and the recorded run (its device
    work, if any, is traced in the warm-up and dropped).  Returns
    (profiler, trace events, fn's result, prepare's result)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            state = prepare() if prepare is not None else None
            torch.cuda.synchronize()
            prof.step()
            out = fn()
            torch.cuda.synchronize()
        events = trace_events(prof)
        lost = lost_device_records(events)
        if not lost:
            return prof, events, out, state
        emit({"phase": "profile", "what": what, "incomplete_trace": attempt + 1,
              "lost_device_records": lost})
    raise AssertionError(f"{what}: the profiler lost device records in "
                         f"{TRACE_ATTEMPTS} traces in a row")


def profile_region(fn, top: int = 12):
    """Run ``fn`` under torch.profiler: device-busy ms (sum of kernel times
    on the one stream), the kernels that took the most device time, every
    kernel's ms and launches (``by_kernel``, ``calls_by_kernel``, not
    printed) and, for each profiler range of ``RANGES``, the device ms of
    the kernels launched inside it (``ranges``, from the range's host-side
    event).  Returns (summary, fn())."""
    prof, _, out, _ = profiled(fn, "profile_region")
    from torch.autograd import DeviceType

    rows, ranges = [], {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if evt.key.startswith("ProfilerStep"):
            continue                         # the schedule's step range, not a kernel
        if evt.key in RANGES:                # a range: its host-side event sums
            if getattr(evt, "device_type", None) == DeviceType.CPU:   # its kernels
                ranges[evt.key] = dev_us / 1e3
            continue                         # (the device-side one spans gaps too)
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue                         # host-side op, not a kernel
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    return ({"device_busy_ms": sum(r[0] for r in rows),
             "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                     for ms, k, n in rows[:top]],
             "by_kernel": {k: ms for ms, k, _ in rows},
             "calls_by_kernel": {k: n for _, k, n in rows},
             "ranges": ranges}, out)


# the work of one call of a kernel wrapper, to pick the largest call of a
# run: (capacity, routed rows) of the grouped FFN, visible pairs of K4's
# rows, rows x span of K3
WORK = {
    "grouped_expert_ffn": lambda x, *a: (x.shape[1], int(a[3].sum())),
    "flash_attention": lambda q, *a, lengths=None, **kw: (
        q.shape[0] * q.shape[1] ** 2 if lengths is None
        else int((lengths.long() ** 2).sum())),
    "decode_attention": lambda q, k, *a: q.shape[0] * k.shape[1],
    "decode_attention_paged": lambda q, *a: q.shape[0] * a[-1],
    "ssd_scan": lambda x, *a, lengths=None, **kw: (
        x.shape[0] * x.shape[1] if lengths is None else int(lengths.long().sum())),
}


@contextlib.contextmanager
def capture_calls(names, keep=None):
    """Wrap the kernel ops ``names`` so that a copy of the arguments of each
    one's largest call (by ``WORK``) is kept: the shapes and data the path
    gives the kernel.  ``keep(name, args)``, when given, says which calls
    count (e.g. only those reading streamed weights).  Yields {name: (args,
    kwargs)}."""
    from repro_torch.kernels import ops

    best, saved = {}, {n: getattr(ops, n) for n in names}

    def copy(v):
        return v.clone() if torch.is_tensor(v) else v

    def wrap(name, fn):
        def call(*args, **kw):
            if keep is not None and not keep(name, args):
                return fn(*args, **kw)
            work = WORK[name](*args, **kw)
            if name not in best or work > best[name][0]:
                best[name] = (work, [copy(a) for a in args],
                              {k: copy(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return call

    for n in names:
        setattr(ops, n, wrap(n, saved[n]))
    calls = {}
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
        calls.update({n: (a, kw) for n, (_, a, kw) in best.items()})


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


def by_experts(fn, x, *ws, counts=None):
    """A plain version over groups of experts, so that its f32 copies stay
    near 2 GB at the long path's prefill capacity (tens of thousands of
    rows); an expert's rows never depend on another expert's."""
    E, C, D = x.shape
    g = max(1, (1 << 31) // (C * D * 4))
    if g >= E:
        return fn(x, *ws, counts)
    out = None
    for e in range(0, E, g):
        part = fn(x[e:e + g], *(w[e:e + g] for w in ws),
                  None if counts is None else counts[e:e + g])
        if out is None:
            out = torch.empty((E,) + part.shape[1:], dtype=part.dtype,
                              device=part.device)
        out[e:e + g] = part
    return out


def check_ffn(name, gen, E, C, D, F, dtype, dev, counts=None, timing=False):
    x, wg, wu, wd = ffn_inputs(gen, E, C, D, F, dtype, dev, counts)
    return check_ffn_on(name, x, wg, wu, wd, counts, timing)


def check_ffn_on(name, x, wg, wu, wd, counts=None, timing=False):
    """K1, K2 and the grouped FFN against their plain versions on these
    inputs; with ``timing``, the K1 and K2 rows of the kernels line."""
    from repro_torch.kernels import expert_gemm, ops, ref

    E, C, D = x.shape
    F, dtype = wg.shape[-1], x.dtype
    tol = tolerance(dtype)
    errs, ref_peak = {}, {}
    # one pair at a time: at the long path's prefill capacity each output
    # is several GB
    got = ops.grouped_expert_ffn(x, wg, wu, wd, counts)
    want = by_experts(ref.expert_ffn_ref, x, wg, wu, wd, counts=counts)
    errs["ffn"], ref_peak["ffn"] = errors(got, want), float(want.abs().max())
    del got, want
    h = ops.expert_gate_up(x, wg, wu, counts)
    h_ref = by_experts(ref.expert_gate_up_ref, x, wg, wu, counts=counts)
    errs["gate_up"], ref_peak["gate_up"] = errors(h, h_ref), float(h_ref.abs().max())
    del h
    down = ops.grouped_matmul(h_ref, wd, counts)
    down_ref = by_experts(ref.grouped_matmul_ref, h_ref, wd, counts=counts)
    errs["grouped_matmul"] = errors(down, down_ref)
    ref_peak["grouped_matmul"] = float(down_ref.abs().max())
    del down, down_ref
    case = {"case": name, "E": E, "C": C, "D": D, "F": F,
            "routed_rows": None if counts is None else int(counts.sum()),
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": {k: e[0] for k, e in errs.items()},
            "rel_err": {k: e[1] for k, e in errs.items()},
            "ref_peak": ref_peak,
            "tolerance": tol}
    emit(case)
    for key, err in errs.items():
        if not within(err, tol):
            raise AssertionError(f"{name}: {key} error {err} outside {tol}")
    if not timing:
        if x.is_cuda and expert_gemm.grouped_matmul_design(dtype, E, F, D) == "wgmma":
            # K1's and K2's two designs on the same inputs, in turns
            def k1():
                return ops.expert_gate_up(x, wg, wu, counts)

            def k1_prev():
                return expert_gemm.expert_gate_up_prev(x, wg, wu, counts)

            def k2():
                return ops.grouped_matmul(h_ref, wd, counts)

            def k2_prev():
                return expert_gemm.grouped_matmul_prev(h_ref, wd, counts)

            emit({"case": name, "k1_ms": time_ms(k1), "k1_prev_ms": time_ms(k1_prev),
                  "k1_ms_again": time_ms(k1), "k2_ms": time_ms(k2),
                  "k2_prev_ms": time_ms(k2_prev), "k2_ms_again": time_ms(k2)})
        return case, None
    es = x.element_size()
    n_live = int(counts.sum()) if counts is not None else E * C
    e_live = int((counts > 0).sum()) if counts is not None else E
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    # K1: live experts' wg+wu, live x rows read once; all of h written
    k1_bytes = e_live * 2 * D * F * es + n_live * D * es + E * C * F * es
    k1_flops = 4.0 * n_live * D * F
    k2_bytes = e_live * F * D * es + n_live * F * es + E * C * D * es
    k2_flops = 2.0 * n_live * F * D

    def lib_gate_up():
        return torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)

    rows = []
    big = E * C > 1 << 18                     # the long path's prefill buffer
    iters, plain_iters = (5, 2) if big else (20, 20)
    for kname, kern, prev, plain, lib, nbytes, flops, err, design in (
        ("expert_gate_up", lambda: ops.expert_gate_up(x, wg, wu, counts),
         lambda: expert_gemm.expert_gate_up_prev(x, wg, wu, counts),
         lambda: by_experts(ref.expert_gate_up_ref, x, wg, wu, counts=counts),
         lib_gate_up, k1_bytes, k1_flops, errs["gate_up"],
         expert_gemm.expert_gate_up_design(dtype, E, D, F, C)),
        ("grouped_matmul", lambda: ops.grouped_matmul(h_ref, wd, counts),
         lambda: expert_gemm.grouped_matmul_prev(h_ref, wd, counts),
         lambda: by_experts(ref.grouped_matmul_ref, h_ref, wd, counts=counts),
         lambda: torch.bmm(h_ref, wd), k2_bytes, k2_flops,
         errs["grouped_matmul"], expert_gemm.grouped_matmul_design(dtype, E, F, D)),
    ):
        b_ms, b_by = bound(nbytes, flops, peak)
        row = {"name": kname, "case": name, "max_abs_err": err[0],
               "rel_err": err[1], "tolerance": tol, "design": design}
        row.update({"ms": time_ms(kern, iters),
                    "plain_ms": time_ms(plain, plain_iters, 1),
                    "library_ms": time_ms(lib, iters), "bound_ms": b_ms, "bound_by": b_by})
        if design == "wgmma" and x.is_cuda:
            # the first design on the same inputs, timed in turns with the new
            # one; the wrappers' host cost a call where the kernel is short
            row["prev_ms"] = time_ms(prev, iters)
            row["ms_again"] = time_ms(kern, iters)
            if not big:
                row["host_us"] = host_us(kern)
                row["prev_host_us"] = host_us(prev)
        rows.append(row)
    emit({"case": name, "timing": rows})
    return case, rows


def check_attention(name, gen, B, H, K, hd, S, dtype, dev, timing=False, pos=None):
    if pos is None:
        pos = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    else:
        pos = torch.tensor(pos, device=dev, dtype=torch.int32)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    return check_attention_on(name, q, k, v, pos, timing)


def check_attention_on(name, q, k, v, pos, timing=False):
    """K3 against its plain version on these inputs (and keys and values
    past ``pos`` poisoned; a row with ``pos < 0`` must be zeros, the kernel's
    contract where the plain version spreads it evenly); the split design
    also gives row 0 alone bit for bit what it gave inside the batch.  With
    ``timing``, its row of the kernels line."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref

    B, H, hd = q.shape
    S, K, dtype, dev = k.shape[1], k.shape[2], q.dtype, q.device
    design = da.decode_attention_design(dtype, H // K, hd)
    got = ops.decode_attention(q, k, v, pos)
    want = ref.decode_attention_ref(q, k, v, pos)
    want = torch.where((pos < 0)[:, None, None], torch.zeros_like(want), want)
    # poisoned slots past pos must not change the output
    idx = torch.arange(S, device=dev)[None, :, None, None]
    dead = idx > pos[:, None, None, None]
    k2 = torch.where(dead, torch.full_like(k, 1e4), k)
    v2 = torch.where(dead, torch.full_like(v, -1e4), v)
    poisoned = ops.decode_attention(q, k2, v2, pos)
    alone = ops.decode_attention(q[:1].contiguous(), k[:1].contiguous(),
                                 v[:1].contiguous(), pos[:1])
    torch.cuda.synchronize()
    err, err_p = errors(got, want), errors(got, poisoned)[0]
    invariant = bool(torch.equal(alone[0], got[0]))
    zero_rows = all(int(torch.count_nonzero(got[b])) == 0
                    for b in torch.nonzero(pos < 0).flatten().tolist())
    tol = tolerance(dtype)
    emit({"case": name, "B": B, "H": H, "K": K, "hd": hd, "S": S,
          "dtype": str(dtype).replace("torch.", ""), "design": design,
          "max_abs_err": err[0], "rel_err": err[1],
          "ref_peak": float(want.float().abs().max()), "poisoned_diff": err_p,
          "row0_alone_bit_identical": invariant, "zero_rows_pos_lt_0": zero_rows,
          "tolerance": tol})
    if not within(err, tol):
        raise AssertionError(f"{name}: error {err} outside {tol}")
    if not err_p < 1e-5:
        raise AssertionError(f"{name}: poisoned slots changed the output by {err_p}")
    if not zero_rows or (design == "split" and q.is_cuda and not invariant):
        raise AssertionError(f"{name}: rows with pos < 0 not zero ({zero_rows}) or row "
                             f"0 alone differs from row 0 in the batch ({invariant})")
    if not timing:
        return None
    es = q.element_size()
    n_valid = int(torch.clamp(pos.long() + 1, min=0, max=S).sum())
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

    def kern():
        return ops.decode_attention(q, k, v, pos)

    row = {"name": "decode_attention", "case": name, "max_abs_err": err[0],
           "rel_err": err[1], "tolerance": tol, "design": design, "ms": time_ms(kern),
           "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, pos)),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    if design == "split" and q.is_cuda:
        # the first design on the same inputs, timed in turns with the new
        # one, and both wrappers' host cost a call (the decode tick is
        # host-bound)
        def prev():
            return da.decode_attention_prev(q, k, v, pos)

        row.update({"prev_ms": time_ms(prev), "ms_again": time_ms(kern),
                    "host_us": host_us(kern), "prev_host_us": host_us(prev)})
    emit({"case": name, "timing": [row]})
    return row


def paged_inputs(gen, n, H, K, hd, span, pt, dtype, dev, win_frac=0.5):
    """n rows of ``span`` slots in ``pt``-slot pages, a ``win_frac`` share of
    the frames in a window beside the device pool, frames shuffled over
    both (the null frame P never used)."""
    pages = -(-span // pt)
    Hf = int(n * pages * win_frac)
    P = n * pages - Hf

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pk, pv = rand(P + 1, pt, K, hd), rand(P + 1, pt, K, hd)
    ek, ev = (rand(Hf, pt, K, hd), rand(Hf, pt, K, hd)) if Hf else (None, None)
    ids = torch.randperm(n * pages, generator=gen, device=dev)
    frames = torch.where(ids < P, ids, ids + 1).reshape(n, pages).to(torch.int32)
    return rand(n, H, hd), pk, pv, ek, ev, frames


def check_paged(name, gen, n, H, K, hd, span, pt, dtype, dev, pos=None, timing=False,
                win_frac=0.5):
    q, pk, pv, ek, ev, frames = paged_inputs(gen, n, H, K, hd, span, pt, dtype, dev, win_frac)
    if pos is None:
        pos = torch.randint(0, span, (n,), generator=gen, device=dev, dtype=torch.int32)
    else:
        pos = torch.tensor(pos, device=dev, dtype=torch.int32)
    return check_paged_on(name, q, pk, pv, ek, ev, frames, pos, span, timing)


def check_paged_on(name, q, pk, pv, ek, ev, frames, pos, span, timing=False):
    """K3p against its plain version (the gather, then K3's plain version)
    on these inputs, and bit for bit against K3 on the gathered contiguous
    copy; rows with pos < 0 must be zeros.  With ``timing``, its row of the
    kernels line: K3p, K3 on the gathered copy (the yardstick: no single
    PyTorch call computes a paged gather-attention) and the byte bound."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref

    n, H, hd = q.shape
    pt, K, dtype = pk.shape[1], pk.shape[2], q.dtype
    pos = pos.to(torch.int32).reshape(-1).expand(n).contiguous()
    design = da.decode_attention_design(dtype, H // K, hd)
    got = ops.decode_attention_paged(q, pk, pv, ek, ev, frames, pos, span)
    want = ref.decode_attention_paged_ref(q, pk, pv, ek, ev, frames, pos, span)
    want = torch.where((pos < 0)[:, None, None], torch.zeros_like(want), want)
    gk = ref.gather_pages(pk, ek, frames, span).contiguous()
    gv = ref.gather_pages(pv, ev, frames, span).contiguous()
    k3 = ops.decode_attention(q, gk, gv, pos)
    torch.cuda.synchronize()
    err = errors(got, want)
    bit = bool(torch.equal(got, k3))
    tol = tolerance(dtype)
    emit({"case": name, "kernel": "decode_attention_paged", "n": n, "H": H, "K": K, "hd": hd,
          "span": span, "page_tokens": pt, "pool_frames": pk.shape[0],
          "window_frames": 0 if ek is None else ek.shape[0],
          "dtype": str(dtype).replace("torch.", ""), "design": design,
          "max_abs_err": err[0], "rel_err": err[1], "tolerance": tol,
          "bit_identical_to_k3_on_gathered_copy": bit})
    if not within(err, tol):
        raise AssertionError(f"{name}: error {err} outside {tol}")
    if not bit:
        raise AssertionError(f"{name}: K3p differs from K3 on the gathered copy")
    if not timing:
        return None
    es = q.element_size()
    n_valid = int(torch.clamp(pos.long() + 1, min=0, max=span).sum())
    pages_read = int(sum(-(-min(max(int(p) + 1, 0), span) // pt) for p in pos.tolist()))
    nbytes = 2 * n_valid * K * hd * es + 2 * n * H * hd * es + n * 4 + pages_read * 4
    b_ms, b_by = bound(nbytes, 4.0 * n_valid * H * hd,
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)

    def kern():
        return ops.decode_attention_paged(q, pk, pv, ek, ev, frames, pos, span)

    def contiguous():
        return ops.decode_attention(q, gk, gv, pos)

    row = {"name": "decode_attention_paged", "case": name, "max_abs_err": err[0],
           "rel_err": err[1], "tolerance": tol, "design": design, "ms": time_ms(kern),
           "k3_ms": time_ms(contiguous),
           "plain_ms": time_ms(lambda: ref.decode_attention_paged_ref(q, pk, pv, ek, ev,
                                                                       frames, pos, span)),
           "library_ms": None, "library": "none (no single PyTorch call gathers pages)",
           "bound_ms": b_ms, "bound_by": b_by, "page_tokens": pt, "span": span}
    row["ms_again"] = time_ms(kern)
    row["k3_ms_again"] = time_ms(contiguous)
    emit({"case": name, "timing": [row]})
    return row


def long_lengths(n: int = LONG_REQUESTS):
    return [LONG_MIN + ((LONG_MAX - LONG_MIN) * i) // (n - 1) for i in range(n)]


def naive_bf16_probs(q, k, v, window: int, n: int):
    """The reference's naive attention numerics on batch row 0's first ``n``
    rows: f32 softmax, probabilities rounded to v's dtype before a bf16 PV
    product (K4 rounds the unnormalised ones)."""
    H, hd = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    kb = k[0, :n].repeat_interleave(G, dim=1).transpose(0, 1)     # (H, n, hd)
    vb = v[0, :n].repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((n, H, hd), dtype=q.dtype, device=q.device)
    kpos = torch.arange(n, device=q.device)
    for lo in range(0, n, 512):
        hi = min(n, lo + 512)
        s = torch.einsum("qhd,hkd->hqk", q[0, lo:hi].float(), kb.float()) * hd ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        mask = kpos[None, :] <= qpos
        if window:
            mask &= qpos - kpos[None, :] < window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1).to(v.dtype)
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", p, vb)
    return out


def check_flash(name, gen, B, S, H, K, hd, dtype, dev, window=0, lengths=None):
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]
    lens = (None if lengths is None
            else torch.tensor(lengths, device=dev, dtype=torch.int32))
    return check_flash_on(name, q, k, v, window, lens)


def check_flash_on(name, q, k, v, window=0, lens=None):
    """K4 against its plain version (and timed) on these inputs; with
    ``lens``, rows past them must be zeros and keys past them set to 1e4
    must change nothing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    B, S, H, hd = q.shape
    K, dtype, dev = k.shape[2], q.dtype, q.device
    lengths = None if lens is None else [int(n) for n in lens.tolist()]
    design = fa.flash_attention_design(dtype, hd)

    def kern():
        return ops.flash_attention(q, k, v, window=window, lengths=lens)

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window, lengths=lens)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, tol = errors(got, want), tolerance(dtype)
    live = [S] * B if lengths is None else list(lengths)
    zero_rows = all(int(torch.count_nonzero(got[b, n:])) == 0
                    for b, n in enumerate(live))
    poisoned_diff = 0.0
    if lengths is not None:
        dead = torch.arange(S, device=dev)[None, :, None, None] >= lens[:, None, None, None]
        k2 = torch.where(dead, torch.full_like(k, 1e4), k)
        v2 = torch.where(dead, torch.full_like(v, 1e4), v)
        poisoned_diff = float((ops.flash_attention(q, k2, v2, window=window, lengths=lens)
                               - got).abs().max())
    case = {"case": name, "B": B, "S": S, "H": H, "K": K, "hd": hd,
            "window": window, "lengths": None if lengths is None else
            [min(live), max(live)], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err[0], "rel_err": err[1],
            "ref_peak": float(want.float().abs().max()),
            "zero_rows_past_lengths": zero_rows, "poisoned_diff": poisoned_diff,
            "tolerance": tol, "design": design}
    if dtype == torch.bfloat16:
        # the size of the reference's own bf16 rounding of the probabilities
        twin = naive_bf16_probs(q, k, v, window, live[0])
        case["vs_naive_bf16_probs_rel"] = errors(got[0, :live[0]], twin)[1]
    if not (within(err, tol) and zero_rows and poisoned_diff == 0.0):
        emit(case)
        raise AssertionError(f"{name}: K4 error {err} outside {tol}, zero rows "
                             f"{zero_rows}, poisoned diff {poisoned_diff}")
    # operations: QK^T and PV over every visible (query, key) pair
    pairs = 0
    for n in live:
        i = torch.arange(n, dtype=torch.float64)
        lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
        pairs += float((i - lo + 1).sum())
    es = q.element_size()
    nbytes = sum(live) * (H + 2 * K) * hd * es + B * S * H * hd * es
    flops = 4.0 * H * hd * pairs
    b_ms, b_by = bound(nbytes, flops,
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if lengths is None and not window:
        mask = None                              # is_causal is the same function
    else:                                        # the same function on live rows
        i = torch.arange(S, device=dev)
        m = i[None, :] <= i[:, None]
        if window:
            m &= i[:, None] - i[None, :] < window
        klive = i[None, :] < torch.tensor(live, device=dev)[:, None]     # (B, S)
        mask = (m[None] & klive[:, None, :])[:, None]                     # (B,1,S,S)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=H != K)

    iters = 10 if S * B > 8192 else 20
    case.update({"ms": time_ms(kern, iters), "plain_ms": time_ms(plain, 3, 1),
                 "library_ms": time_ms(lib, iters),
                 # is_causal over the whole S (no lengths, no window)
                 "sdpa_causal_ms": time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True, enable_gqa=H != K), iters),
                 "bound_ms": b_ms, "bound_by": b_by})
    if design == "wgmma" and q.is_cuda:
        # the first design on the same inputs, timed in turns with the new one
        case["prev_ms"] = time_ms(lambda: fa.flash_attention_prev(
            q, k, v, window=window, lengths=lens), iters)
        case["ms_again"] = time_ms(kern, iters)
    case["tflops"] = flops / case["ms"] / 1e9
    emit(case)
    row = {"name": "flash_attention", "case": name, "max_abs_err": err[0],
           "rel_err": err[1], "tolerance": tol, "design": design, "ms": case["ms"],
           "plain_ms": case["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": case["library_ms"]}
    for key in ("prev_ms", "ms_again"):
        if key in case:
            row[key] = case[key]
    return row


def check_flash_offset(name, gen, B, Sq, q_offset, H, K, hd, dtype, dev, lengths=None):
    """K4 with a query offset (a prefix-cache hit's suffix prefill): q (B, Sq,
    H, hd) at absolute positions q_offset.. against k/v (B, q_offset + Sq, K,
    hd), held to its plain version and timed beside SDPA with a lower-right
    causal mask.  The same rows of a full causal call over the whole sequence
    (queries for the prefix made up) must agree within the same tolerance;
    whether they are bit-identical is recorded."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    Sk = q_offset + Sq
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]
    lens = (None if lengths is None
            else torch.tensor(lengths, device=dev, dtype=torch.int32))
    design = fa.flash_attention_design(dtype, hd)

    def kern():
        return ops.flash_attention(q, k, v, lengths=lens, q_offset=q_offset)

    def plain():
        return ref.flash_attention_ref(q, k, v, lengths=lens, q_offset=q_offset)

    got, want = kern(), plain()
    q_pre = torch.randn((B, q_offset, H, hd), generator=gen, device=dev).to(dtype)
    full = ops.flash_attention(torch.cat([q_pre, q], dim=1), k, v, lengths=lens)[:, q_offset:]
    torch.cuda.synchronize()
    err, tol = errors(got, want), tolerance(dtype)
    full_err = errors(got, full)
    live = [Sk] * B if lengths is None else [min(Sk, int(n)) for n in lengths]
    zero_rows = all(int(torch.count_nonzero(got[b, max(0, n - q_offset):])) == 0
                    for b, n in enumerate(live))
    case = {"case": name, "B": B, "Sq": Sq, "q_offset": q_offset, "Sk": Sk, "H": H, "K": K,
            "hd": hd, "lengths": lengths, "dtype": str(dtype).replace("torch.", ""),
            "design": design, "max_abs_err": err[0], "rel_err": err[1],
            "ref_peak": float(want.float().abs().max()), "zero_rows_past_lengths": zero_rows,
            "vs_full_call_abs": full_err[0], "vs_full_call_rel": full_err[1],
            "full_call_bit_identical": bool(torch.equal(got, full)),
            "q_offset_multiple_of_query_block": q_offset % (128 if design == "wgmma" else 64)
            == 0, "tolerance": tol}
    if not (within(err, tol) and within(full_err, tol) and zero_rows):
        emit(case)
        raise AssertionError(f"{name}: K4 with q_offset {q_offset}: error {err}, against "
                             f"the full call {full_err}, outside {tol}; zero rows {zero_rows}")
    pairs = sum(float(q_offset + i + 1) for n in live for i in range(Sq) if q_offset + i < n)
    es = q.element_size()
    n_q = sum(max(0, min(Sq, n - q_offset)) for n in live)
    nbytes = (n_q * H + sum(live) * 2 * K) * hd * es + B * Sq * H * hd * es
    flops = 4.0 * H * hd * pairs
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = "sdpa(attn_mask=causal_lower_right(Sq, Sk), enable_gqa)"
    if lens is None:
        from torch.nn.attention.bias import causal_lower_right

        mask = causal_lower_right(Sq, Sk)
    else:                                    # the same function with lengths
        i = torch.arange(Sq, device=dev)[:, None] + q_offset
        j = torch.arange(Sk, device=dev)[None, :]
        mask = ((j <= i)[None] & (j[None] < lens[:, None, None].long()))[:, None]
        library = "sdpa(attn_mask=boolean causal and length mask, enable_gqa)"

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != K)

    case.update({"ms": time_ms(kern), "plain_ms": time_ms(plain, 5, 1),
                 "library_ms": time_ms(lib), "library": library,
                 "bound_ms": b_ms, "bound_by": b_by})
    case["ms_again"] = time_ms(kern)
    emit(case)
    return {"name": "flash_attention", "case": name, "max_abs_err": err[0],
            "rel_err": err[1], "tolerance": tol, "design": design, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": case["library_ms"], "ms_again": case["ms_again"],
            "q_offset": q_offset, "Sq": Sq,
            "full_call_bit_identical": case["full_call_bit_identical"]}


def ssm_lengths(n: int = SSM_REQUESTS):
    return [SSM_MIN + ((SSM_MAX - SSM_MIN) * i) // (n - 1) for i in range(n)]


def ssd_inputs(gen, Bt, S, nh, hp, ns, dtype, dev):
    """x, B and C at scale 0.5, dt = softplus(normal) and A = -uniform(1, 16)
    (Mamba2's A_log init): the decay reaches |cum| in the thousands over a
    256-long chunk, as on the served path."""
    x, B, C = [(torch.randn(s, generator=gen, device=dev) * 0.5).to(dtype)
               for s in ((Bt, S, nh, hp), (Bt, S, ns), (Bt, S, ns))]
    dt = torch.nn.functional.softplus(torch.randn((Bt, S, nh), generator=gen, device=dev))
    A = -(1.0 + 15.0 * torch.rand((nh,), generator=gen, device=dev))
    return x, B, C, dt, A


def check_ssd(name, gen, Bt, S, nh, hp, ns, chunk, dtype, dev, lengths=None):
    x, B, C, dt, A = ssd_inputs(gen, Bt, S, nh, hp, ns, dtype, dev)
    lens = (None if lengths is None
            else torch.tensor(lengths, device=dev, dtype=torch.int32))
    return check_ssd_on(name, x, B, C, dt, A, chunk, lens)


def ssd_work(Bt, S, nh, hp, ns, chunk, lengths, es):
    """(bytes, operations) the SSD scan needs on these inputs: x, B, C and dt
    of the live positions read once, y and the state written once; per chunk
    of q live positions, q^2 ns for C B^T (its causal half, shared by the
    heads) and per head q^2 hp for M x plus 4 q ns hp for C H and the state
    update."""
    live = [S] * Bt if lengths is None else [min(S, max(0, int(n))) for n in lengths]
    n_live = sum(live)
    nbytes = (n_live * (nh * hp + 2 * ns) * es + n_live * nh * 4 + nh * 4
              + Bt * S * nh * hp * es + Bt * nh * ns * hp * 4)
    flops = 0.0
    for n in live:
        for lo in range(0, n, chunk):
            q = min(chunk, n - lo)
            flops += q * q * ns + nh * (q * q * hp + 4.0 * q * ns * hp)
    return nbytes, flops


def check_ssd_on(name, x, B, C, dt, A, chunk, lens=None):
    """K5 against its plain version on these inputs, timed: y (f32 within
    TOL_SSD_F32, bf16 rows within REL_BF16 of their peak), every y row past
    ``lens`` exactly zero, the f32 state per (row, head) slice within
    REL_SSD_STATE of its peak; on the card, inputs past ``lens`` set to NaN
    change no bit; the shortest row run alone at S = its length gives the same
    bits as inside the batch.  The mma design is timed in turns with the
    first one on the same inputs.  No single PyTorch call computes the SSD
    scan, so the library column is null."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss

    Bt, S, nh, hp = x.shape
    ns, dtype, dev = B.shape[-1], x.dtype, x.device
    design = ss.ssd_scan_design(dtype, hp, ns, chunk)

    def kern():
        return ops.ssd_scan(x, B, C, dt, A, chunk, lengths=lens)

    def plain():
        return ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lens)

    (y, h), (y_ref, h_ref) = kern(), plain()
    live = [S] * Bt if lens is None else [int(n) for n in lens.tolist()]
    poisoned_diff = 0.0
    if lens is not None and x.is_cuda:       # (the plain version multiplies by 0)
        dead = torch.arange(S, device=dev)[None, :] >= lens[:, None]
        nan = float("nan")
        y2, h2 = ops.ssd_scan(
            torch.where(dead[..., None, None], torch.full_like(x, nan), x),
            torch.where(dead[..., None], torch.full_like(B, nan), B),
            torch.where(dead[..., None], torch.full_like(C, nan), C),
            torch.where(dead[..., None], torch.full_like(dt, nan), dt), A, chunk,
            lengths=lens)
        poisoned_diff = max(float((y2.float() - y.float()).abs().max()),
                            float((h2 - h).abs().max()))
        del y2, h2
    b = min(range(Bt), key=lambda r: live[r])          # the shortest row, alone
    n = live[b]
    ya, ha = ops.ssd_scan(*(t[b:b + 1, :n].contiguous() for t in (x, B, C, dt)), A, chunk)
    alone = bool(torch.equal(ya[0], y[b, :n]) and torch.equal(ha[0], h[b]))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        y_err = errors(y, y_ref)
        y_ok = y_err[0] < TOL_SSD_F32
        tol = {"abs": TOL_SSD_F32, "state_rel_per_slice": REL_SSD_STATE}
    else:
        y_err = errors(y, y_ref)
        y_ok = y_err[1] < REL_BF16
        tol = {"rel_per_row": REL_BF16, "state_rel_per_slice": REL_SSD_STATE}
    d = (h - h_ref).abs().amax((-2, -1))
    state_rel = float((d / h_ref.abs().amax((-2, -1)).clamp_min(
        torch.finfo(torch.float32).tiny)).max())
    zero_rows = all(int(torch.count_nonzero(y[b, n:])) == 0 for b, n in enumerate(live))
    case = {"case": name, "B": Bt, "S": S, "nh": nh, "hp": hp, "ns": ns, "chunk": chunk,
            "lengths": None if lens is None else [min(live), max(live)],
            "dtype": str(dtype).replace("torch.", ""), "design": design,
            "max_abs_err": y_err[0], "rel_err": y_err[1],
            "ref_peak": float(y_ref.float().abs().max()),
            "state_rel_err": state_rel, "state_peak": float(h_ref.abs().max()),
            "zero_rows_past_lengths": zero_rows, "poisoned_diff": poisoned_diff,
            "shortest_row_alone_bit_identical": alone, "tolerance": tol}
    if not (y_ok and state_rel < REL_SSD_STATE and zero_rows and poisoned_diff == 0.0
            and alone):
        emit(case)
        raise AssertionError(f"{name}: K5 y error {y_err}, state {state_rel}, zero rows "
                             f"{zero_rows}, poisoned diff {poisoned_diff}, row alone "
                             f"bit-identical {alone}, outside {tol}")
    nbytes, flops = ssd_work(Bt, S, nh, hp, ns, chunk, None if lens is None else live,
                             x.element_size())
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    big = Bt * S * nh > 1 << 20
    iters = 5 if big else 20
    case.update({"ms": time_ms(kern, iters),
                 "plain_ms": time_ms(plain, 2 if big else 5, 1),
                 "library_ms": None,
                 "library": "none: no single PyTorch call computes the SSD scan",
                 "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                 "gbytes": nbytes / 1e9})
    if design == "mma" and x.is_cuda:
        # the first design on the same inputs, timed in turns with the new one
        case["prev_ms"] = time_ms(lambda: ss.ssd_scan_prev(x, B, C, dt, A, chunk,
                                                           lengths=lens), iters)
        case["ms_again"] = time_ms(kern, iters)
    emit(case)
    row = {"name": "ssd_scan", "case": name, "design": design, "max_abs_err": y_err[0],
           "rel_err": y_err[1], "state_rel_err": state_rel, "tolerance": tol,
           "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    for key in ("prev_ms", "ms_again"):
        if key in case:
            row[key] = case[key]
    return row


def phase_kernels(dev, plan, span: int, prompt_len: int, long_b_a: int,
                  ssm_b_a: int):
    """The serve phases' shapes: decode capacity min(b_e, B), prefill
    capacity next_pow2(max expert load) of a b_a x prompt_len micro-batch
    (the engine's probe), decode attention over b_a rows of a span-slot
    cache and over the long path's 32 rows at span 3648, and K4 at the
    long path's prefill micro-batch (its ``long_b_a`` longest prompts) plus
    GQA, window and f32 cases.  Each serve phase also holds every kernel to
    its plain version on the inputs its own path gave it
    (``check_path_kernels``)."""
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
    # D 100, F 60: rows of 200 and 120 bytes, which TMA cannot address, so
    # K2 takes its first (wmma) design
    check_ffn("unaligned-K-N-bf16", gen, 3, 70, 100, 60, bf, dev)
    check_ffn("mixtral-expert", gen, 8, 64, 4096, 14336, bf, dev)
    rows.append(check_attention("olmoe-decode", gen, plan.b_a, 16, 16, 128, span,
                                bf, dev, timing=True))
    check_attention("olmoe-B64-S512", gen, 64, 16, 16, 128, 512, bf, dev)
    check_attention("olmoe-B64-S512-f32", gen, 64, 16, 16, 128, 512, f32, dev)
    check_attention("gqa-32-8", gen, 64, 32, 8, 128, 512, bf, dev)
    check_attention("gqa-32-8-f32", gen, 8, 32, 8, 128, 512, f32, dev)
    # K3 at the long path's span: ragged positions 1024..3647
    long_span = LONG_MAX + LONG_DECODE
    long_pos = [LONG_MIN + ((long_span - 1 - LONG_MIN) * i) // (LONG_REQUESTS - 1)
                for i in range(LONG_REQUESTS)]
    rows.append(check_attention("olmoe-decode-long", gen, LONG_REQUESTS, 16, 16, 128,
                                long_span, bf, dev, timing=True, pos=long_pos))
    # a Mixtral-shaped GQA row set at the same span, and rows at the split
    # edges (slot 0, L - 1, L, the last slot) and one with no valid slot
    rows.append(check_attention("mixtral-gqa-decode-long", gen, LONG_REQUESTS, 32, 8, 128,
                                long_span, bf, dev, timing=True, pos=long_pos))
    from repro_torch.kernels.decode_attention import SPLIT_SLOTS as L

    check_attention("split-edges", gen, 5, 16, 16, 128, long_span, bf, dev,
                    pos=[0, L - 1, L, long_span - 1, -1])
    # K3p: the paged path's shape (32 rows at span 3648 in 128-slot pages,
    # half the frames in the window), 8-slot pages at the serve span and at
    # smoke size (hd 32: the first design), a sliding-window ring, the split
    # edges with a dead row, and f32 (the parity phase's design)
    rows.append(check_paged("olmoe-paged-long-pt128", gen, LONG_REQUESTS, 16, 16, 128,
                            long_span, PAGE_TOKENS, bf, dev, pos=long_pos, timing=True))
    rows.append(check_paged("olmoe-pt8", gen, plan.b_a, 16, 16, 128, span, 8, bf, dev,
                            timing=True))
    check_paged("smoke-hd32-pt8", gen, 4, 8, 2, 32, 100, 8, bf, dev)
    check_paged("ring-pt8", gen, 4, 16, 16, 128, 256, 8, bf, dev, pos=[300, 1000, 255, 17])
    check_paged("paged-split-edges", gen, 5, 16, 16, 128, long_span, PAGE_TOKENS, bf, dev,
                pos=[0, L - 1, L, long_span - 1, -1])
    check_paged("olmoe-paged-f32", gen, 4, 16, 16, 128, 512, 8, f32, dev)
    # K4: the long path's prefill micro-batch, a Mixtral-shaped GQA case, a
    # sliding window, and f32 (the parity shape)
    lens = long_lengths()
    rows.append(check_flash("olmoe-long-prefill", gen, long_b_a, LONG_MAX, 16, 16,
                            128, bf, dev, lengths=lens[-long_b_a:]))
    rows.append(check_flash("mixtral-gqa-S4096", gen, 2, 4096, 32, 8, 128, bf, dev))
    rows.append(check_flash("window-1024-S4096", gen, 2, 4096, 16, 16, 128, bf, dev,
                            window=1024))
    rows.append(check_flash("olmoe-f32-S1536", gen, 2, 1536, 16, 16, 128, f32, dev,
                            lengths=[1536, 1100]))
    # K4 with a query offset: serve_prefix's suffixes (16..128 queries after
    # a 1024-token prefix), an offset that is no multiple of any tile, the
    # Mixtral GQA shape, lengths, f32 and hd 32 (the first design)
    for sq in PREFIX_SUFFIXES:
        rows.append(check_flash_offset(f"olmoe-suffix-{sq}-at-{PREFIX_LEN}", gen, 1, sq,
                                       PREFIX_LEN, 16, 16, 128, bf, dev))
    rows.append(check_flash_offset("olmoe-suffix-64-at-1000", gen, 1, 64, 1000, 16, 16, 128,
                                   bf, dev))
    rows.append(check_flash_offset(f"mixtral-gqa-suffix-128-at-{PREFIX_LEN}", gen, 1, 128,
                                   PREFIX_LEN, 32, 8, 128, bf, dev))
    rows.append(check_flash_offset("olmoe-suffix-lengths", gen, 2, 100, 1000, 16, 16, 128, bf,
                                   dev, lengths=[1100, 1040]))
    rows.append(check_flash_offset("olmoe-suffix-f32", gen, 1, 64, 1000, 16, 16, 128, f32, dev))
    rows.append(check_flash_offset("smoke-hd32-suffix", gen, 2, 20, 45, 4, 2, 32, bf, dev))
    # K5: the SSM path's heaviest prefill micro-batch (its b_a longest
    # prompts, padded to the wave's 1800), the same in f32 at 4 rows, the
    # Jamba/Mamba2 smoke shape (hp 32, ns 16, chunk 32), lengths of 1 and of
    # exactly one chunk, and no lengths
    lens = ssm_lengths()
    rows.append(check_ssd("mamba2-ssm-prefill", gen, ssm_b_a, SSM_MAX, 32, 64, 128, 256,
                          bf, dev, lengths=lens[-ssm_b_a:]))
    rows.append(check_ssd("mamba2-ssm-prefill-f32", gen, 4, SSM_MAX, 32, 64, 128, 256,
                          f32, dev, lengths=lens[-4:]))
    for dtype in (f32, bf):
        rows.append(check_ssd(f"smoke-hp32-ns16-{str(dtype)[6:]}", gen, 4, 100, 16, 32, 16,
                              32, dtype, dev, lengths=[100, 77, 32, 1]))
    rows.append(check_ssd("mamba2-len-1-256", gen, 3, 600, 32, 64, 128, 256, bf, dev,
                          lengths=[1, 256, 600]))
    rows.append(check_ssd("mamba2-no-lengths", gen, 2, 512, 32, 64, 128, 256, bf, dev))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: full-width serving through the port's Server
# ---------------------------------------------------------------------------
def serve_setup(lens, decode_len: int, arch: str = "olmoe-1b-7b", omega: float = 0.0,
                batch=None):
    """A served path on a full-size config: the planner's plan on the H100
    profile for these prompts at ``batch`` slots (default: one per prompt),
    with b_e raised to B (one expert can take every token of a step, so no
    copy drops and both schedulers must give identical tokens) and
    ``omega`` host-attention rows (0 unless a phase asks: the planner's own
    omega at these shapes is 1)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM_80GB
    from repro_torch.launch.serve import build_plan

    cfg = get_config(arch)
    n = len(lens)
    B = batch or n
    args = argparse.Namespace(prompt_lens=lens, decode_len=decode_len,
                              scheduler="static", batch=B, requests=n, b_e=B, omega=omega)
    return cfg, build_plan(cfg, H100_SXM_80GB, args), lens, decode_len


def short_lengths(n: int = 64):
    return [64 + (192 * i) // (n - 1) for i in range(n)]


def init_weights(dev, arch: str = "olmoe-1b-7b"):
    """A full-size config in bf16, seeded, on the card (OLMoE's weights are
    shared by both of its serve phases)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.weights import tree_bytes

    t0 = time.perf_counter()
    params = M.init_params(get_config(arch), seed=0, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "weights", "arch": arch, "init_s": time.perf_counter() - t0,
          "weights_gb": tree_bytes(params) / 1e9})
    return params


def freed(phase: str, what: str, before: int) -> None:
    """After ``del server`` alone (no ``gc.collect()``), the card's allocated
    bytes must fall back to what they were before the server was built."""
    now = torch.cuda.memory_allocated()
    emit({"phase": phase, "freed": what, "allocated_before": before,
          "allocated_after_del": now})
    if now != before:
        raise AssertionError(f"{phase}: {what} left {now - before} bytes allocated "
                             f"after del")


def padded_prompts(requests):
    """(n, S) right-padded prompts and their (n,) lengths."""
    import numpy as np

    lengths = np.array([len(r.prompt) for r in requests], np.int64)
    prompts = np.zeros((len(requests), int(lengths.max())), np.int64)
    for i, r in enumerate(requests):
        prompts[i, :lengths[i]] = r.prompt
    return prompts, lengths


def per_module_oracle(dev, cfg, params, plan, requests, decode_len: int, phase: str,
                      sampler=None):
    """The per-module path (``fused_decode=False``: eager launches, one
    position upload a tick) on the same requests as one wave: prefill, the
    first token, then ``decode_len - 1`` ticks in one chunk, as ``generate``
    does (greedy unless a ``sampler`` is given).  Returns its (n,
    decode_len) tokens, its launch counts and its decode timing; its engine
    must free its cache when deleted."""
    import numpy as np

    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.sampling import BatchSampler

    prompts, lengths = padded_prompts(requests)
    n = len(requests)
    before = torch.cuda.memory_allocated()
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=int(lengths.max()) + decode_len,
                               device=dev, fused_decode=False)
    sampler = sampler or BatchSampler.uniform(n, None)
    ops.reset_launch_counts()
    tok0 = sampler.sample(eng.prefill(prompts, lengths=lengths))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat = eng.decode_chunk(tok0, lengths, sampler, decode_len - 1)
    toks = torch.cat([tok0[:, None], mat], dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if eng.stats.fused_dispatches:
        raise AssertionError(f"{phase}: the per-module oracle took the fused path")
    del eng, tok0, mat
    freed(phase, "per-module oracle engine", before)
    timing = {"decode_s": decode_s, "tick_wall_ms": decode_s * 1e3 / (decode_len - 1),
              "decode_tok_s": n * (decode_len - 1) / decode_s}
    return toks, counts, timing


def serve_both(dev, cfg, params, plan, requests, decode_len: int, phase: str,
               serve_kw=None):
    """Serve ``requests`` through the port's ``Server`` under the static and
    then the continuous scheduler, the launch counts set to 0 just before
    each run and read just after, then the per-module oracle on the same
    requests.  Fails unless every request gets its ``decode_len`` tokens,
    every decode tick of both schedulers was a graph replay of the fused
    tick, every kernel of the path (``PATH_KERNELS``) was launched, each
    launch count equals the oracle's, no routed copy dropped, both
    schedulers and the oracle give identical tokens and each deleted server
    frees its cache and graphs (device and page-locked bytes) by reference
    counting.  ``serve_kw`` goes to ``ServeConfig``."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server

    serve_kw = serve_kw or {}

    n_requests = len(requests)
    # warm-up pass (cuBLAS handles, allocator, kernel libraries) so both
    # timed schedulers run warm; its launches are not counted
    before = torch.cuda.memory_allocated()
    warm = Server(cfg, params, plan, serve=ServeConfig(decode_len=2), device=dev)
    for r in requests[:2]:
        warm.submit(r)
    warm.run()
    del warm
    freed(phase, "warm-up server", before)
    tokens, reports, counts = {}, {}, {}
    for sched in ("static", "continuous"):
        before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
        server = Server(cfg, params, plan,
                        serve=ServeConfig(scheduler=sched, decode_len=decode_len, **serve_kw),
                        device=dev)
        for r in requests:
            server.submit(r)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[sched] = ops.launch_counts()
        reports[sched] = rep
        tokens[sched] = [r.tokens for r in rep.request_results]
        st = server._engine.stats
        ticks = rep.decode_slot_steps // plan.B
        # the engine's graphs are captured in its first chunk, inside the
        # server's decode time
        setup = sum(c["warmup_s"] + c["capture_s"] for c in server._engine.graph_captures)
        emit({"phase": phase, "scheduler": sched, "wall_s": wall,
              "prefill_tokens": rep.prefill_tokens, "prefill_s": rep.prefill_s,
              "prefill_tok_s": rep.prefill_throughput,
              "decode_tokens": rep.decode_tokens, "decode_s": rep.decode_s,
              "decode_tok_s": rep.decode_throughput,
              "server_ms_per_tick": rep.decode_s * 1e3 / ticks,
              "capture_s": setup,
              "decode_tok_s_past_capture": rep.decode_tokens / (rep.decode_s - setup),
              "server_ms_per_tick_past_capture": (rep.decode_s - setup) * 1e3 / ticks,
              "decode_ticks": ticks, "fused_ticks": st.fused_ticks,
              "fused_dispatches": st.fused_dispatches, "decode_chunk": plan.decode_chunk,
              "graph_captures": server._engine.graph_captures,
              "dropped": rep.expert_tokens_dropped,
              "decode_slot_steps": rep.decode_slot_steps,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "host_attn_tokens": rep.host_attn_tokens, "host_attn_s": st.host_attn_s,
              "planned_reads": st.planned_reads, "pinned_gb": wmod.pinned_bytes() / 1e9,
              "launches": counts[sched]})
        reports[sched].stats = st
        if dev.type == "cuda" and not (st.fused_dispatches > 0 and st.fused_ticks == ticks):
            raise AssertionError(f"{sched}: {ticks} decode ticks, {st.fused_ticks} of them "
                                 f"graph replays ({st.fused_dispatches} chunks)")
        if dev.type == "cuda" and not all(counts[sched][k] > 0 for k in PATH_KERNELS[phase]):
            raise AssertionError(f"{sched}: a kernel of the path was never launched: "
                                 f"{counts[sched]}")
        if dev.type == "cuda" and any(counts[sched][k] != counts[sched][f"{k}_{d}"]
                                      for k, d in NEW_DESIGNS):
            raise AssertionError(f"{sched}: a kernel launch of the path did not take its "
                                 f"new design (NEW_DESIGNS: K1, K2, K4 wgmma, K3 split, "
                                 f"K5 mma): {counts[sched]}")
        if len(rep.request_results) != n_requests or any(
                r.tokens.size != decode_len for r in rep.request_results):
            raise AssertionError(f"{sched}: wrong number of tokens served")
        if rep.expert_tokens_dropped != 0:
            raise AssertionError(f"{sched}: {rep.expert_tokens_dropped} copies dropped")
        del server, st
        freed(phase, f"{sched} server", before)
        if wmod.pinned_bytes() != pinned:
            raise AssertionError(f"{phase} {sched}: the deleted server left "
                                 f"{wmod.pinned_bytes() - pinned} page-locked bytes")
    oracle, oracle_counts, timing = per_module_oracle(dev, cfg, params, plan, requests,
                                                      decode_len, phase)
    emit({"phase": phase, "oracle": "per-module (fused_decode=False)", **timing,
          "launches": oracle_counts})
    for sched in ("static", "continuous"):
        if counts[sched] != oracle_counts:
            raise AssertionError(f"{sched}: launch counts {counts[sched]} differ from the "
                                 f"per-module oracle's {oracle_counts}")
    for i, (a, b) in enumerate(zip(tokens["static"], tokens["continuous"])):
        if not np.array_equal(a, b):
            step = int(np.flatnonzero(a != b)[0]) if a.shape == b.shape else -1
            raise AssertionError(f"static and continuous schedulers gave different "
                                 f"tokens: request {i}, first at step {step}")
        if not np.array_equal(a, oracle[i]):
            step = int(np.flatnonzero(a != oracle[i])[0])
            raise AssertionError(f"fused and per-module tokens differ: request {i}, "
                                 f"first at step {step}")
    flat = np.concatenate(tokens["static"])
    if flat.min() < 0 or flat.max() >= cfg.vocab_size:
        raise AssertionError("token ids out of range")
    return tokens, reports, counts


def phase_sampled(dev, params, n: int = 16):
    """Seeded sampling on the serve path at ``n`` requests: greedy,
    temperature and top-k slots mixed, through the fused server (static)
    and through the per-module oracle armed the way the server arms its
    slots.  Identical tokens, and the server's decode ticks all replays of
    the sampled tick's graph."""
    import numpy as np

    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.sampling import BatchSampler, SamplingParams
    from repro_torch.serving.server import ServeConfig, Server

    cfg, plan, lens, decode_len = serve_setup(short_lengths()[::64 // n], 32)
    kinds = [None, SamplingParams(0.8, 0, 1), SamplingParams(0.7, 50, 2),
             SamplingParams(1.0, 5, 3)]
    requests = synthetic_requests(DatasetSpec("sampled", n, max(lens), decode_len),
                                  cfg.vocab_size, seed=1, prompt_lens=lens)
    requests = [replace(r, sampling=kinds[i % len(kinds)]) for i, r in enumerate(requests)]
    before = torch.cuda.memory_allocated()
    server = Server(cfg, params, plan, serve=ServeConfig(decode_len=decode_len), device=dev)
    for r in requests:
        server.submit(r)
    rep = server.run()
    got = [r.tokens for r in rep.request_results]
    st = server._engine.stats
    ticks = rep.decode_slot_steps // plan.B
    keys = [c["key"] for c in server._engine.graph_captures]
    emit({"phase": "sampled", "requests": n, "decode_tok_s": rep.decode_throughput,
          "server_ms_per_tick": rep.decode_s * 1e3 / ticks, "fused_ticks": st.fused_ticks,
          "decode_ticks": ticks, "graph_captures": server._engine.graph_captures})
    sampled_graph = any(not k["greedy_only"] for k in keys) or dev.type != "cuda"
    if not (st.fused_ticks == ticks and sampled_graph):
        raise AssertionError(f"sampled: {st.fused_ticks} of {ticks} ticks replayed, "
                             f"keys {keys}")
    del server, st
    freed("sampled", "server", before)
    sampler = BatchSampler(n)
    for i, r in enumerate(requests):
        sampler.set_slot(i, r.sampling)
    want, _, _ = per_module_oracle(dev, cfg, params, plan, requests, decode_len, "sampled",
                                   sampler=sampler)
    same = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
    emit({"phase": "sampled", "tokens_match": all(same),
          "kinds": [None if k is None else [k.temperature, k.top_k] for k in kinds],
          "distinct_streams": len({tuple(t) for t in got})})
    if not all(same):
        raise AssertionError(f"sampled: fused and per-module tokens differ for requests "
                             f"{[i for i, ok in enumerate(same) if not ok]}")


def check_path_kernels(phase: str, calls) -> list:
    """Hold every kernel to its plain version, timed, on the inputs of the
    largest call its path made (``capture_calls``)."""
    rows = []
    for where, name in sorted(calls):
        args, kw = calls.pop((where, name))
        case = f"{phase}-{where}"
        if name == "grouped_expert_ffn":
            rows += check_ffn_on(case, *args, timing=True)[1]
        elif name == "ssd_scan":
            rows.append(check_ssd_on(case, *args, lens=kw.get("lengths")))
        elif name == "flash_attention":
            rows.append(check_flash_on(case, *args, window=kw.get("window", 0),
                                       lens=kw.get("lengths")))
        elif name == "decode_attention_paged":
            rows.append(check_paged_on(case, *args, timing=True))
        else:
            rows.append(check_attention_on(case, *args, timing=True))
        del args, kw
    emit({"phase": phase, "path_kernel_cases": rows})
    return rows


# the kernel ops whose largest call each path captures, at prefill and decode
PREFILL_CAPTURE = {"serve": ("grouped_expert_ffn", "flash_attention"),
                   "serve_long": ("grouped_expert_ffn", "flash_attention"),
                   "serve_ssm": ("ssd_scan",)}
DECODE_CAPTURE = {"serve": ("grouped_expert_ffn", "decode_attention"),
                  "serve_long": ("grouped_expert_ffn", "decode_attention"),
                  "serve_ssm": ()}               # Mamba2's decode is plain PyTorch
# device kernels by what issued them, first match wins: the port's own
# kernels by name (K1 is gate_up_wgmma_kernel or gemm_*_kernel<true>, K2
# gemm_wgmma_kernel or gemm_*_kernel<false>, K3 decode_split_kernel or
# decode_attn_kernel, K5 ssd_mma_kernel or ssd_scan_kernel), then library
# matrix products
KERNEL_CLASSES = (("K5", ("ssd_mma_kernel", "ssd_scan_kernel")),
                  ("K4", ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")),
                  ("K3", ("decode_split_kernel", "decode_attn_kernel")),
                  ("K1", ("gate_up_wgmma_kernel", "gemm_bf16_kernel<true>",
                          "gemm_f32_kernel<true>")),
                  ("K2", ("gemm_wgmma_kernel", "gemm_bf16_kernel<false>",
                          "gemm_f32_kernel<false>")),
                  ("library GEMM (projections, LM head, einsums)",
                   ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")))


def kernel_class(name: str) -> str:
    """The KERNEL_CLASSES class of a device kernel's name."""
    return next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                "other (elementwise, copies, reductions)")


def kernel_shares(by_kernel: dict, busy: float) -> dict:
    """Device ms and share of ``busy`` of each KERNEL_CLASSES class, and of
    the rest (elementwise glue, copies, reductions)."""
    out = {}
    for name, ms in by_kernel.items():
        cls = kernel_class(name)
        out[cls] = out.get(cls, 0.0) + ms
    return {c: {"ms": ms, "share_of_busy": ms / busy} for c, ms in out.items()}


# the port's kernels by the class their device kernels fall in
CLASS_OF_KERNEL = {"expert_gate_up": "K1", "grouped_matmul": "K2", "decode_attention": "K3",
                   "flash_attention": "K4", "ssd_scan": "K5"}


@contextlib.contextmanager
def ssm_decode_range():
    """Run every ``models.ssm.ssm_decode`` call inside a profiler range, so
    that the device time of the plain recurrent step (its projections
    included) can be read from the trace."""
    from torch.profiler import record_function

    from repro_torch.models import ssm as ssm_mod

    orig = ssm_mod.ssm_decode

    def wrapped(*a, **kw):
        with record_function("ssm_decode"):
            return orig(*a, **kw)

    ssm_mod.ssm_decode = wrapped
    try:
        yield
    finally:
        ssm_mod.ssm_decode = orig


def profile_path(dev, phase, cfg, params, plan, requests, max_seq, reports,
                 profile=False, steps: int = 8):
    """A fresh engine on a served path's prompts: one prefill wave with the
    kernels' largest calls captured, one chunk of ``steps`` per-module
    ticks with the same (eager: a graph capture records and does not run
    the wrappers' arguments), then the fused chunk of ``steps`` graph
    replays and one token read, as the server decodes: its wall per tick.
    Under ``profile``: a torch.profiler breakdown of the replayed chunk --
    the kernels the device ran, held to the replay accounting (each class's
    launches = ``steps`` x the launches the capture recorded) -- the host
    syncs inside the chunk (there must be none), and one prefill wave.
    Then every captured kernel is held to its plain version
    (``check_path_kernels``)."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.sampling import BatchSampler

    n = len(requests)
    tick_ms = {s: rep.decode_s * 1e3 / (rep.decode_slot_steps / plan.B)
               for s, rep in reports.items()}
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq, device=dev)
    prompts, lengths = padded_prompts(requests)
    sampler = BatchSampler.uniform(n, None)
    with capture_calls(PREFILL_CAPTURE[phase]) as pre:
        lg = eng.prefill(prompts, lengths=lengths)
    tok0 = sampler.sample(lg)

    def chunk():
        return eng.decode_chunk(tok0, lengths, sampler, steps)

    def decode_ticks():
        return chunk().cpu()

    eng.fused_decode = False
    with capture_calls(DECODE_CAPTURE[phase]) as dec:
        decode_ticks()
    eng.fused_decode = True
    decode_ticks()                                          # captures the graph
    wall = host_ms(decode_ticks) / steps
    lg2 = eng.decode_step(tok0, lengths)
    if not (torch.isfinite(lg).all() and torch.isfinite(lg2).all()):
        raise AssertionError(f"{phase}: non-finite logits")
    emit({"phase": phase, "what": "decode_tick", "B": n,
          "positions": [int(lengths.min()), int(lengths.max())],
          "wall_ms_per_tick": wall, "server_ms_per_tick": tick_ms,
          "graph_captures": eng.graph_captures})
    if profile:
        # device busy from the profiler; walls from unprofiled runs
        with ssm_decode_range():
            prof, _ = profile_region(decode_ticks)
        busy = prof["device_busy_ms"] / steps
        per_tick = {c: {"ms": v["ms"] / steps, "share_of_busy": v["share_of_busy"]}
                    for c, v in kernel_shares(prof["by_kernel"], prof["device_busy_ms"]).items()}
        seen = {}
        for name, calls in prof["calls_by_kernel"].items():
            seen[kernel_class(name)] = seen.get(kernel_class(name), 0) + calls
        recorded = eng.graph_captures[-1]["launches_per_replay"] if eng.graph_captures else {}
        replayed = {c: seen.get(c, 0) for c in CLASS_OF_KERNEL.values()}
        want = {CLASS_OF_KERNEL[k]: steps * recorded.get(k, 0) for k in CLASS_OF_KERNEL}
        hidden = sync_sites(chunk)
        emit({"phase": "profile", "what": f"{phase} decode tick B={n}, per tick "
              f"(one chunk of {steps} graph replays)",
              "wall_ms": wall, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall,
              "idle_share_vs_server": {s: 1.0 - busy / ms for s, ms in tick_ms.items()},
              "by_class": per_tick,
              "kernels_in_replays": replayed, "replay_accounting": want,
              "ranges_ms_per_tick": {k: v / steps for k, v in prof["ranges"].items()},
              "sync_sites_in_chunk": hidden,
              "sync_sites_with_read": sync_sites(decode_ticks),
              "top_over_steps": prof["top"]})
        if dev.type == "cuda" and replayed != want:
            raise AssertionError(f"{phase}: the device ran {replayed} of the port's "
                                 f"kernels in {steps} replays; the accounting says {want}")
        if hidden:
            raise AssertionError(f"{phase}: host syncs inside the decode chunk: {hidden}")
        wall_p = host_ms(lambda: eng.prefill(prompts, lengths=lengths))
        prof, _ = profile_region(lambda: eng.prefill(prompts, lengths=lengths))
        busy = prof["device_busy_ms"]
        emit({"phase": "profile", "what": f"{phase} prefill of the {n} prompts, one wave",
              "wall_ms": wall_p, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall_p,
              "by_class": kernel_shares(prof["by_kernel"], busy),
              "server_prefill_ms": {s: rep.prefill_s * 1e3 for s, rep in reports.items()},
              "top": prof["top"]})
    del eng, lg, lg2
    torch.cuda.empty_cache()
    calls = {("prefill", k): v for k, v in pre.items()}
    calls.update({("decode", k): v for k, v in dec.items()})
    return check_path_kernels(phase, calls)


def phase_serve(dev, params, profile=False):
    """64 requests of 64..256 tokens, decode 32, through the port's
    ``Server`` (both schedulers), then the path's kernels on its own
    inputs."""
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    n_requests = len(lens)
    requests = synthetic_requests(
        DatasetSpec("smoke", n_requests, max(lens), decode_len),
        cfg.vocab_size, seed=0, prompt_lens=lens)
    _, reports, counts = serve_both(dev, cfg, params, plan, requests,
                                    decode_len, "serve")
    profile_path(dev, "serve", cfg, params, plan, requests,
                 max(lens) + decode_len, reports, profile)
    phase_sampled(dev, params)
    phase_replan(dev, params)
    return counts, reports


def watch_decode_syncs(server) -> dict:
    """Record the Python lines where the host waited for the device inside
    every decode chunk and every re-plan check of ``server`` (its engine
    built), by PyTorch's sync debug mode; a graph capture (set-up, once per
    key) runs with the mode off.  Returns {file:line: count}, filled as the
    server runs; ``untap`` removes the wrappers."""
    eng, seen = server._engine, {}
    capture = eng._graph

    def watched(fn):
        def call(*a, **kw):
            out = []
            for k, n in sync_sites(lambda: out.append(fn(*a, **kw))).items():
                seen[k] = seen.get(k, 0) + n
            return out[0]
        return call

    def unwatched(*a, **kw):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return capture(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    eng.decode_chunk, eng._graph = watched(eng.decode_chunk), unwatched
    server._maybe_replan = watched(server._maybe_replan)
    return seen


def untap(obj) -> None:
    """Drop the instance attributes that wrap ``obj``'s methods (a tap's
    wrapper holds the object, so it would outlive ``del``)."""
    for name in [n for n, v in vars(obj).items() if callable(v) and hasattr(type(obj), n)]:
        delattr(obj, name)


def served(dev, cfg, params, plan, requests, serve_kw: dict, fused: bool = True,
           phase: str = "serve", taps=None):
    """One ``Server`` run of ``requests`` with ``ServeConfig(**serve_kw)``
    (``fused=False``: the per-module oracle, its engine's fused decode off),
    the launch counts set to 0 just before and read just after, the host
    syncs inside its decode chunks and re-plan checks recorded
    (``watch_decode_syncs``).  ``taps(server)``, when given, wraps what it wants
    to watch before the run.  The deleted server must free its device and
    page-locked bytes.  Returns a record of the run."""
    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server

    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    server = Server(cfg, params, plan, serve=ServeConfig(**serve_kw), device=dev)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    server._engine.fused_decode = fused
    seen = taps(server) if taps is not None else None
    syncs = watch_decode_syncs(server)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = server._engine
    untap(server)
    untap(eng)
    rec = {"report": rep, "counts": ops.launch_counts(), "wall_s": wall,
           "tokens": [r.tokens for r in rep.request_results],
           "ticks": rep.decode_slot_steps // server._b, "syncs": dict(syncs),
           "planned_reads": eng.stats.planned_reads, "fused_ticks": eng.stats.fused_ticks,
           "graph_captures": list(eng.graph_captures), "b_e_override": eng._b_e_override,
           "seen": seen,
           "table": None if eng.pages is None else eng.pages.describe()}
    del server, eng
    freed(phase, f"{serve_kw.get('scheduler', 'static')} server", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError(f"{phase}: the deleted server left "
                             f"{wmod.pinned_bytes() - pinned} page-locked bytes")
    return rec


def phase_replan(dev, params):
    """Serve's 64 requests with online capacity re-planning: one decode tick
    a step (re-plan checks at steps 8, 16 and 24 of the 31), ``replan_skew``
    below the drift of the hottest expert's share that the seeded routing
    shows.  Static and continuous (fused) and the per-module oracle
    (static, the same re-plans) give identical tokens; each run re-plans at
    least once, captures one graph per distinct capacity, makes one
    planned read per 8 steps and no other host wait inside its decode
    chunks and re-plan checks.  The measured shares are printed."""
    import numpy as np

    from repro_torch.data.datasets import DatasetSpec, synthetic_requests

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    requests = synthetic_requests(DatasetSpec("smoke", len(lens), max(lens), decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    kw = {"decode_len": decode_len, "decode_chunk": 1, "replan_skew": REPLAN_SKEW}

    def taps(server):
        """The hottest expert's share at each check, and each b_e pushed."""
        shares, pushed = [], []
        check, push = server._maybe_replan, server._engine.set_expert_capacity

        def watch_check():
            check()
            load = server.report.expert_load
            if server._replan_ticks % 8 == 0 and load is not None:
                per = load.sum(axis=0)
                shares.append(float(per.max() / per.sum()))

        def watch_push(b_e):
            pushed.append(b_e)
            push(b_e)

        server._maybe_replan, server._engine.set_expert_capacity = watch_check, watch_push
        return {"shares": shares, "pushed": pushed}

    runs = {}
    for name, sched, fused in (("static", "static", True), ("continuous", "continuous", True),
                               ("per-module", "static", False)):
        rec = served(dev, cfg, params, plan, requests, dict(kw, scheduler=sched), fused,
                     "serve_replan", taps)
        runs[name] = rec
        rep, seen = rec["report"], rec["seen"]
        caps = [c["key"]["capacity"] for c in rec["graph_captures"]]
        drift = [b - a for a, b in zip(seen["shares"], seen["shares"][1:])]
        emit({"phase": "serve_replan", "run": name, "replan_skew": REPLAN_SKEW,
              "hottest_share_at_checks": seen["shares"], "drift_between_checks": drift,
              "b_e_pushed": seen["pushed"], "capacity_replans": rep.capacity_replans,
              "planned_reads": rec["planned_reads"], "decode_steps": rec["ticks"],
              "graph_capacities": caps, "sync_sites": rec["syncs"],
              "dropped": rep.expert_tokens_dropped, "decode_tok_s": rep.decode_throughput,
              "fused_ticks": rec["fused_ticks"], "launches": rec["counts"]})
        cuda = dev.type == "cuda"
        if not (rep.capacity_replans >= 1 and rep.capacity_replans == len(seen["pushed"])
                and rec["planned_reads"] == rec["ticks"] // 8 and not rec["syncs"]):
            raise AssertionError(f"serve_replan {name}: {rep.capacity_replans} re-plans "
                                 f"({seen['pushed']}), {rec['planned_reads']} planned reads in "
                                 f"{rec['ticks']} steps, sync sites {rec['syncs']}")
        if fused and cuda and not (len(caps) == len(set(caps))
                                   and set(caps) == {plan.B} | set(seen["pushed"])
                                   and rec["fused_ticks"] == rec["ticks"]):
            raise AssertionError(f"serve_replan {name}: graph capacities {caps} for pushes "
                                 f"{seen['pushed']}; {rec['fused_ticks']} of {rec['ticks']} "
                                 f"ticks replayed")
    for name in ("continuous", "per-module"):
        for i, (a, b) in enumerate(zip(runs["static"]["tokens"], runs[name]["tokens"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"serve_replan: static and {name} tokens differ for "
                                     f"request {i}")
        if runs[name]["seen"]["pushed"] != runs["static"]["seen"]["pushed"]:
            raise AssertionError(f"serve_replan: {name} pushed {runs[name]['seen']['pushed']}"
                                 f", static {runs['static']['seen']['pushed']}")


def prefix_requests(cfg):
    """One seeded ``PREFIX_LEN``-token instruction in front of each of
    ``PREFIX_REQUESTS`` seeded questions, their lengths even-spread over
    ``PREFIX_QUESTIONS``."""
    import numpy as np

    from repro_torch.serving.server import Request

    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    n, (lo, hi) = PREFIX_REQUESTS, PREFIX_QUESTIONS
    lens = [lo + ((hi - lo) * i) // (n - 1) for i in range(n)]
    return [Request(np.concatenate([head, rng.integers(0, cfg.vocab_size, m)]).astype(np.int32),
                    PREFIX_DECODE) for m in lens]


def first_logits(server):
    """Record each request's first-token logits (its row of the prefill
    logits, or a hit's) by request index: {index: (V,) f32 on the host}."""
    eng, out, current = server._engine, {}, {}
    wave, prefill, hit = server._prefill_wave, eng.prefill_slots, eng.prefill_prefix_hit

    def prefill_wave(handles, slots):
        current.update({s: h.index for h, s in zip(handles, slots)})
        return wave(handles, slots)

    def prefill_slots(tokens, rows, lengths=None):
        lg = prefill(tokens, rows, lengths=lengths)
        for s, row in zip(rows, lg.float().cpu()):
            out[current[int(s)]] = row
        return lg

    def prefill_prefix_hit(slot, prompt, kvs, pos0):
        from repro_torch.kernels import ops

        k4 = ops.launch_counts()["flash_attention"]
        lg = hit(slot, prompt, kvs, pos0)
        out[current[slot]] = lg[0].float().cpu()
        out.setdefault("k4_per_hit", []).append(ops.launch_counts()["flash_attention"] - k4)
        return lg

    server._prefill_wave = prefill_wave
    eng.prefill_slots, eng.prefill_prefix_hit = prefill_slots, prefill_prefix_hit
    return out


def profile_hits(dev, cfg, params, plan, requests, n: int = 8):
    """A fresh engine (Mode A pages): one miss prefilled and its prefix
    captured, then ``n`` hits admitted into rows 1.., as the server admits
    them (one at a time): the wall per hit, and under torch.profiler the
    device-busy time and device operations (kernels, copies) per hit, its
    split by kernel class, the top kernels and copies, and the Python lines
    that made the host wait."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.cache import CacheConfig

    before = torch.cuda.memory_allocated()
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=PREFIX_MAX_SEQ, device=dev,
                               cache_config=CacheConfig(page_tokens=PAGE_TOKENS))
    eng.init_cache(plan.B)
    eng.prefill_slots(requests[0].prompt[None], [0])
    kvs = eng.read_prefix_rows(0, PREFIX_LEN)
    hits = requests[plan.B:plan.B + n]

    def admit():
        for i, r in enumerate(hits):
            eng.prefill_prefix_hit(1 + i % (plan.B - 1), r.prompt, kvs, PREFIX_LEN)

    admit()                                          # warm
    wall = host_ms(admit) / n
    prof, _ = profile_region(admit, top=8)
    busy = prof["device_busy_ms"] / n
    syncs = sync_sites(admit)
    emit({"phase": "profile", "what": f"serve_prefix: {n} prefix hits admitted one at a time, "
          f"per hit", "suffix_tokens": [len(r.prompt) - PREFIX_LEN for r in hits],
          "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
          "device_ops_per_hit": sum(prof["calls_by_kernel"].values()) / n,
          "by_class": {c: {"ms": v["ms"] / n, "share_of_busy": v["share_of_busy"]}
                       for c, v in kernel_shares(prof["by_kernel"],
                                                 prof["device_busy_ms"]).items()},
          "sync_sites_per_hit": {k: v / n for k, v in syncs.items()},
          "top_over_hits": prof["top"]})
    del eng, kvs
    torch.cuda.empty_cache()
    freed("serve_prefix", "profiled hit engine", before)


def cold_alone(dev, cfg, params, plan, prompts):
    """Each prompt prefilled cold and alone (one row, the whole prompt) by a
    fresh engine with serve_prefix's pages, its prefix captured, and the
    prompt admitted again as a hit on that capture.  Returns, per prompt,
    (cold logits, hit logits), (V,) f32 on the host: the two share their
    prefix KV bit for bit, so they differ only where the suffix runs
    through GEMMs of its own length, not the prompt's (an offset or RoPE
    fault would show in every prompt)."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.cache import CacheConfig

    before = torch.cuda.memory_allocated()
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=PREFIX_MAX_SEQ, device=dev,
                               cache_config=CacheConfig(page_tokens=PAGE_TOKENS))
    eng.init_cache(2)
    out = []
    for p in prompts:
        cold = eng.prefill_slots(p[None], [0])[0].float().cpu()
        kvs = eng.read_prefix_rows(0, PREFIX_LEN)
        out.append((cold, eng.prefill_prefix_hit(1, p, kvs, PREFIX_LEN)[0].float().cpu()))
        del kvs
    del eng
    torch.cuda.empty_cache()
    freed("serve_prefix", "cold-alone engine", before)
    return out


def phase_serve_prefix(dev, params, profile=False):
    """Full-width, full-depth OLMoE-1B-7B, 64 requests of one 1024-token
    shared instruction plus a 16..128-token question each, decode 32, B 32,
    the planner's b_a, b_e = B, 128-token pages (Mode A), max_seq 1280: a
    static wave of 32 misses, then a wave of 32 hits.  Cold (prefix cache
    off) and with the prefix cache, under both schedulers, and the
    per-module oracle with the prefix cache.  Gates: static = continuous =
    the oracle with the prefix cache; 32 hits and 32 misses; 16 K4 launches
    per hit; every hit's first-token logits within the bf16 row tolerance of
    the cold run's; each prompt prefilled cold and alone against its hit on
    that prefill's prefix (``cold_alone``): at least a quarter bit-identical
    and the median within the row tolerance; one planned read (the one capture) and no other host
    wait inside the decode chunks; every server freed.  Then Mode B (half
    the frames on the host, K3p): tokens bit-identical to Mode A's."""
    import numpy as np

    cfg, _, _, _ = serve_setup([PREFIX_LEN + 16], PREFIX_DECODE)
    requests = prefix_requests(cfg)
    lens = [len(r.prompt) for r in requests]
    _, plan, _, _ = serve_setup(lens, PREFIX_DECODE, batch=PREFIX_REQUESTS // 2)
    B = plan.B
    frame = cfg.num_layers * 2 * PAGE_TOKENS * cfg.num_kv_heads * cfg.head_dim * 2
    frames = B * -(-PREFIX_MAX_SEQ // PAGE_TOKENS)
    half_gb = (frames // 2) * frame / 1e9
    emit({"phase": "serve_prefix", "requests": len(requests), "prefix_len": PREFIX_LEN,
          "prompt_lens": [min(lens), max(lens)], "decode_len": PREFIX_DECODE,
          "max_seq": PREFIX_MAX_SEQ, "page_tokens": PAGE_TOKENS,
          "plan": {"B": B, "b_a": plan.b_a, "b_e": plan.b_e}, "frames": frames,
          "mode_b_device_kv_gb": half_gb, "card": gpu_line()})
    base = {"decode_len": PREFIX_DECODE, "max_seq": PREFIX_MAX_SEQ, "kv_page_tokens": PAGE_TOKENS}
    runs = {}
    for name, sched, prefix, fused, extra in (
            ("cold-static", "static", False, True, {}),
            ("cold-continuous", "continuous", False, True, {}),
            ("prefix-static", "static", True, True, {}),
            ("prefix-continuous", "continuous", True, True, {}),
            ("prefix-per-module", "static", True, False, {}),
            ("prefix-mode-B", "static", True, True, {"device_kv_gb": half_gb})):
        kw = dict(base, scheduler=sched, prefix_cache=prefix, **extra)
        rec = served(dev, cfg, params, plan, requests, kw, fused, "serve_prefix", first_logits)
        runs[name] = rec
        rep, c = rec["report"], rec["counts"]
        waves = [{"prefill_s": w.prefill_s, "decode_s": w.decode_s} for w in rep.results]
        k4_hits = rec["seen"].pop("k4_per_hit", [])
        emit({"phase": "serve_prefix", "run": name, "wall_s": rec["wall_s"],
              "prefix_hits": rep.prefix_hits, "prefix_misses": rep.prefix_misses,
              "prefill_tokens": rep.prefill_tokens, "prefill_s": rep.prefill_s,
              "prefill_tok_s": rep.prefill_throughput, "waves": waves,
              "decode_tok_s": rep.decode_throughput, "decode_ticks": rec["ticks"],
              "fused_ticks": rec["fused_ticks"], "planned_reads": rec["planned_reads"],
              "sync_sites": rec["syncs"], "k4_launches_per_hit": sorted(set(k4_hits)),
              "kv_htod_gb": rep.kv_htod_gb, "kv_dtoh_gb": rep.kv_dtoh_bytes / 1e9,
              "table": rec["table"], "dropped": rep.expert_tokens_dropped, "launches": c})
        cuda = dev.type == "cuda"
        want_k3 = "decode_attention_paged" if "device_kv_gb" in kw else "decode_attention"
        if cuda and not all(c[k] > 0 for k in ("expert_gate_up", "grouped_matmul",
                                                want_k3, "flash_attention")):
            raise AssertionError(f"serve_prefix {name}: a kernel of the path was never "
                                 f"launched: {c}")
        if cuda and any(c[k] != c[f"{k}_{d}"] for k, d in NEW_DESIGNS):
            raise AssertionError(f"serve_prefix {name}: a launch did not take its new "
                                 f"design: {c}")
        if len(rec["tokens"]) != len(requests) or rep.expert_tokens_dropped:
            raise AssertionError(f"serve_prefix {name}: {len(rec['tokens'])} requests served, "
                                 f"{rep.expert_tokens_dropped} copies dropped")
        if rec["syncs"]:
            raise AssertionError(f"serve_prefix {name}: host syncs inside the decode chunks: "
                                 f"{rec['syncs']}")
        if not prefix:
            continue
        hits = len(requests) - B
        if (rep.prefix_hits, rep.prefix_misses) != (hits, B) or (
                cuda and k4_hits != [cfg.num_layers] * hits):
            raise AssertionError(f"serve_prefix {name}: {rep.prefix_hits} hits, "
                                 f"{rep.prefix_misses} misses; K4 launches per hit {k4_hits}")
        if "device_kv_gb" not in kw and rec["planned_reads"] != 1:
            raise AssertionError(f"serve_prefix {name}: {rec['planned_reads']} planned reads, "
                                 f"1 capture expected")
    # tokens: static = continuous = the per-module oracle with the prefix
    # cache; Mode B = Mode A bit for bit; the share equal to the cold run's
    want = runs["prefix-static"]["tokens"]
    for name in ("prefix-continuous", "prefix-per-module", "prefix-mode-B"):
        bad = [i for i, (a, b) in enumerate(zip(want, runs[name]["tokens"]))
               if not np.array_equal(a, b)]
        if bad:
            raise AssertionError(f"serve_prefix: {name} tokens differ from prefix-static for "
                                 f"requests {bad}")
    cold = runs["cold-static"]["tokens"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(want, cold)]
    # the hits' first-token logits against the cold run's, row tolerance
    lg, lg_cold = runs["prefix-static"]["seen"], runs["cold-static"]["seen"]
    hit_idx = [i for i in range(B, len(requests))]
    rel = [errors(lg[i][None], lg_cold[i][None])[1] for i in hit_idx]
    alone = cold_alone(dev, cfg, params, plan, [requests[i].prompt for i in hit_idx])
    rel_alone = [errors(h[None], c[None])[1] for c, h in alone]
    rel_wave_alone = [errors(lg[i][None], c[None])[1] for i, (c, _) in zip(hit_idx, alone)]
    miss_rel = [errors(lg[i][None], lg_cold[i][None])[1] for i in range(B)]
    wave = {name: [w.prefill_s for w in runs[name]["report"].results]
            for name in ("cold-static", "prefix-static")}
    toks = [sum(lens[:B]), sum(lens[B:]), sum(n - PREFIX_LEN for n in lens[B:])]
    emit({"phase": "serve_prefix", "share_equal_to_cold_tokens": {
              "misses": float(np.mean(same[:B])), "hits": float(np.mean(same[B:]))},
          "hit_first_logits_rel_err": [min(rel), max(rel)],
          "alone_hit_vs_cold_rel_err": rel_alone,
          "alone_hit_bit_identical": sum(r == 0.0 for r in rel_alone),
          "wave_hit_vs_alone_cold_rel_err": rel_wave_alone,
          "miss_first_logits_rel_err": [min(miss_rel), max(miss_rel)],
          "tolerance": REL_BF16,
          "cold_wave2_prefill_s": wave["cold-static"][1],
          "cold_wave2_prompt_tok_s": toks[1] / wave["cold-static"][1],
          "hit_wave_prefill_s": wave["prefix-static"][1],
          "hit_wave_prompt_tok_s": toks[1] / wave["prefix-static"][1],
          "hit_wave_computed_tok_s": toks[2] / wave["prefix-static"][1],
          "hit_over_cold_prefill_wall": wave["prefix-static"][1] / wave["cold-static"][1],
          "miss_wave_prefill_s": wave["prefix-static"][0],
          "cold_wave1_prefill_s": wave["cold-static"][0]})
    if max(rel) >= REL_BF16:
        raise AssertionError(f"serve_prefix: hit first-token logits {max(rel)} off the cold "
                             f"run's, outside {REL_BF16} of the row peak")
    # against each prompt's cold prefill alone, on that prefill's prefix: a
    # fault of the suffix path (offset, RoPE, the stored rows) moves every
    # prompt; the suffix's own GEMM shapes move some, by bf16 rounding and
    # the routing near-ties it tips, and leave the rest bit for bit
    exact = sum(r == 0.0 for r in rel_alone)
    if exact < len(rel_alone) // 4 or float(np.median(rel_alone)) >= REL_BF16:
        raise AssertionError(f"serve_prefix: {exact} of {len(rel_alone)} hits bit-identical "
                             f"to their prompt's cold prefill alone (at least a quarter "
                             f"expected), median {float(np.median(rel_alone))} of the row "
                             f"peak (within {REL_BF16} expected)")
    if profile:
        profile_hits(dev, cfg, params, plan, requests)
    return runs["prefix-static"]["counts"]


# ---------------------------------------------------------------------------
# Phase 5: long prompts through K4 at every prefill layer
# ---------------------------------------------------------------------------
def phase_serve_long(dev, params, profile=False):
    """32 prompts of 1024..3584 tokens, decode 64, through the port's
    ``Server`` (both schedulers) at the planner's plan, b_e = B so nothing
    drops.  K4's launches must equal layers x prefill micro-batches x waves
    (all 32 requests form one wave under both schedulers).  Then the path's
    kernels on its own inputs: the largest prefill capacity buffer of the
    wave, K4's largest micro-batch, a decode tick's FFN and K3."""
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.weights import tree_bytes

    cfg, plan, lens, decode_len = serve_setup(long_lengths(), LONG_DECODE)
    n = len(lens)
    max_seq = LONG_MAX + LONG_DECODE
    kv_bytes = (n * max_seq * cfg.num_layers * 2 * cfg.num_kv_heads
                * cfg.head_dim * 2)
    emit({"phase": "serve_long", "requests": n, "prompt_lens": [min(lens), max(lens)],
          "prompt_tokens": sum(lens), "decode_len": decode_len, "max_seq": max_seq,
          "plan": {"B": plan.B, "b_a": plan.b_a, "b_e": plan.b_e},
          "weights_gb": tree_bytes(params) / 1e9, "kv_gb": kv_bytes / 1e9})
    requests = synthetic_requests(DatasetSpec("long", n, LONG_MAX, decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    _, reports, counts = serve_both(dev, cfg, params, plan, requests, decode_len,
                                    "serve_long")
    want = cfg.num_layers * -(-n // plan.b_a) * 1
    for sched, c in counts.items():
        emit({"phase": "serve_long", "scheduler": sched,
              "k4_launches": c["flash_attention"], "k4_expected": want})
        if dev.type == "cuda" and (c["flash_attention"] != want or want <= 0):
            raise AssertionError(f"{sched}: K4 launched {c['flash_attention']} "
                                 f"times, expected {want}")
    profile_path(dev, "serve_long", cfg, params, plan, requests, max_seq, reports,
                 profile)
    return counts["static"], reports


# ---------------------------------------------------------------------------
# The host-attention path (omega) and the paged, host-tiered KV cache
# ---------------------------------------------------------------------------
def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo`` (on an Arm host,
    which has none, its implementer and part codes) and architecture."""
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    name = fields.get("model name")
    if name is None:                     # no model name: the ids there are
        ids = ("vendor_id", "cpu family", "model", "CPU implementer", "CPU part")
        name = " ".join(f"{k} {fields[k]}" for k in ids if k in fields) or "unknown"
    return f"{name} ({platform.machine()})"


def phase_serve_omega(dev, params, resident=None):
    """Serve's 64 requests (64..256 tokens, decode 32) at omega 0.5: rows
    0-31 attend on the host CPU (projections on the card, q/k/v down in one
    planned read a layer, the §B mechanism on the CPU, the output up from
    page-locked memory), rows 32-63 replay the fused graph.  Static,
    continuous and the per-module oracle give identical tokens; the host
    split is 32 rows x 16 layers a tick, with one planned read per attention
    layer and host tick and no other host wait in a chunk.  Reports the
    CPU's ms per host-attention layer and its share of a tick, and the share
    of requests whose tokens equal ``serve``'s omega-0 tokens (``resident``:
    that phase's (counts, reports)), which is not a gate: the host mechanism
    rounds to bf16 where K3 does not."""
    import numpy as np

    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.sampling import BatchSampler

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32, omega=OMEGA)
    plan = replace(plan, b_a=OMEGA_B_A)
    n = len(lens)
    n_host = int(round(plan.omega * plan.B))
    n_attn = cfg.num_layers
    requests = synthetic_requests(DatasetSpec("smoke", n, max(lens), decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    emit({"phase": "serve_omega", "requests": n, "omega": plan.omega, "host_rows": n_host,
          "plan": {"B": plan.B, "b_a": plan.b_a, "b_e": plan.b_e},
          "cpu_count": os.cpu_count(), "cpu_model": cpu_model(), "card": gpu_line()})
    tokens, reports, counts = serve_both(dev, cfg, params, plan, requests, decode_len,
                                         "serve_omega")
    for sched, rep in reports.items():
        st = rep.stats
        ticks = rep.decode_slot_steps // plan.B
        want_host = n_host * n_attn * ticks
        layer_ms = st.host_attn_s * 1e3 / (n_attn * ticks)
        emit({"phase": "serve_omega", "scheduler": sched, "decode_ticks": ticks,
              "host_attn_tokens": rep.host_attn_tokens, "host_attn_reckoned": want_host,
              "planned_reads": st.planned_reads, "planned_reads_reckoned": n_attn * ticks,
              "cpu_ms_per_host_attention_layer": layer_ms,
              "host_attention_share_of_decode": st.host_attn_s / rep.decode_s,
              "decode_tok_s": rep.decode_throughput,
              "prefill_tok_s": rep.prefill_throughput})
        if rep.host_attn_tokens != want_host or st.planned_reads != n_attn * ticks:
            raise AssertionError(f"serve_omega {sched}: {rep.host_attn_tokens} host tokens "
                                 f"and {st.planned_reads} planned reads, reckoned {want_host} "
                                 f"and {n_attn * ticks}")
    if resident is not None:
        ref = [r.tokens for r in resident[1]["static"].request_results]
        same = [bool(np.array_equal(a, b)) for a, b in zip(tokens["static"], ref)]
        emit({"phase": "serve_omega", "share_equal_to_omega0_tokens": {
            "host_rows": float(np.mean(same[:n_host])),
            "device_rows": float(np.mean(same[n_host:]))}})
    # no host wait inside a chunk but the planned reads: a fresh engine, one
    # chunk to capture the device rows' graph, then one under sync debug
    before = torch.cuda.memory_allocated()
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max(lens) + decode_len, device=dev)
    prompts, lengths = padded_prompts(requests)
    sampler = BatchSampler.uniform(n, None)
    tok0 = sampler.sample(eng.prefill(prompts, lengths=lengths))
    eng.decode_chunk(tok0, lengths, sampler, 4).cpu()
    reads = eng.stats.planned_reads
    hidden = sync_sites(lambda: eng.decode_chunk(tok0, lengths + 4, sampler, 4))
    reads = eng.stats.planned_reads - reads
    emit({"phase": "serve_omega", "sync_sites_in_chunk": hidden,
          "planned_reads_in_chunk": reads, "planned_reads_reckoned": 4 * n_attn,
          "graph_captures": eng.graph_captures})
    if hidden or reads != 4 * n_attn or (dev.type == "cuda" and not eng.graph_captures):
        raise AssertionError(f"serve_omega: host syncs {hidden}, {reads} planned reads in a "
                             f"4-tick chunk, graphs {len(eng.graph_captures)}")
    del eng, tok0
    freed("serve_omega", "sync-check engine", before)
    return counts["static"], reports


def paged_run(dev, cfg, params, plan, requests, decode_len: int, sched: str,
              serve_kw: dict) -> dict:
    """One Server run with ``serve_kw`` (the paging knobs): the launch
    counts set to 0 just before the run and read just after; the deleted
    server must free its device and page-locked bytes."""
    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server

    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    server = Server(cfg, params, plan,
                    serve=ServeConfig(scheduler=sched, decode_len=decode_len, **serve_kw),
                    device=dev)
    for r in requests:
        server.submit(r)
    t0 = time.perf_counter()
    server._ensure_engine()
    setup_s = time.perf_counter() - t0
    pages = server._engine.pages
    table = None if pages is None else pages.describe()
    pinned_gb = wmod.pinned_bytes() / 1e9
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = server._engine.stats
    rec = {"report": rep, "counts": counts, "ticks": rep.decode_slot_steps // server._b,
           "wall_s": wall, "setup_s": setup_s, "table": table, "pinned_gb": pinned_gb,
           "fused_ticks": st.fused_ticks, "planned_reads": st.planned_reads,
           "demand_fetches": 0 if pages is None else pages.demand_fetches,
           "copied_bytes": 0 if pages is None else pages.copied_bytes}
    del server, st, pages
    freed("serve_paged", f"{sched} paged server", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError(f"serve_paged: the deleted server left "
                             f"{wmod.pinned_bytes() - pinned} page-locked bytes")
    return rec


def phase_serve_paged(dev, params, long_reports=None):
    """serve_long's 32 prompts (1024..3584 tokens, decode 64, B 32) with
    the KV in 128-slot pages and 7.5 GB of device frames (Mode B): 447 of
    the 928 frames on the card, 481 page-locked on the host, streamed a
    layer ahead on the copy stream and read in place by K3p.  Static and
    continuous in Mode B, then Mode A (the same pages, no cap).  Gates: the
    tokens of every run bit-identical to serve_long's contiguous tokens
    (``long_reports``: that phase's reports; run here when it did not);
    Mode A on the fused graph with no KV byte copied; one K3p launch, in
    its split design, per attention layer and Mode B tick; each server
    freed.  Then a fresh Mode B engine's tick under torch.profiler: the
    host-to-device bytes the table counted equal the trace's, to the byte,
    and the tick's wall beside the host-frame bytes over the measured copy
    rate; K3p held to its plain version on the path's largest call."""
    import numpy as np

    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.sampling import BatchSampler

    cfg, plan, lens, decode_len = serve_setup(long_lengths(), LONG_DECODE)
    n = len(lens)
    max_seq = LONG_MAX + LONG_DECODE
    requests = synthetic_requests(DatasetSpec("long", n, LONG_MAX, decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    if long_reports is None:
        long_reports = {"static": paged_run(dev, cfg, params, plan, requests, decode_len,
                                            "static", {})["report"]}
    want = [r.tokens for r in long_reports["static"].request_results]
    frame = cfg.num_layers * 2 * PAGE_TOKENS * cfg.num_kv_heads * cfg.head_dim * 2
    pages = -(-max_seq // PAGE_TOKENS)
    dev_frames = min(n * pages, int(DEVICE_KV_GB * 1e9 // frame))
    host_frames = n * pages - dev_frames
    layer_bytes = 2 * host_frames * PAGE_TOKENS * cfg.num_kv_heads * cfg.head_dim * 2
    emit({"phase": "serve_paged", "requests": n, "max_seq": max_seq,
          "page_tokens": PAGE_TOKENS, "device_kv_gb": DEVICE_KV_GB, "frame_mb": frame / 1e6,
          "pages_per_row": pages, "frames": n * pages, "device_frames": dev_frames,
          "host_frames": host_frames, "host_gb": host_frames * frame / 1e9,
          "streamed_gb_per_layer_tick": layer_bytes / 1e9, "card": gpu_line(),
          "host": host_meminfo()})
    mode_b = {"kv_page_tokens": PAGE_TOKENS, "device_kv_gb": DEVICE_KV_GB}
    runs = [(sched, mode_b) for sched in ("static", "continuous")]
    runs.append(("static", {"kv_page_tokens": PAGE_TOKENS}))
    counts = None
    for sched, kw in runs:
        rec = paged_run(dev, cfg, params, plan, requests, decode_len, sched, kw)
        rep, c, ticks = rec["report"], rec["counts"], rec["ticks"]
        mode = "B" if "device_kv_gb" in kw else "A"
        got = [r.tokens for r in rep.request_results]
        same = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
        emit({"phase": "serve_paged", "mode": mode, "scheduler": sched,
              "wall_s": rec["wall_s"], "setup_s": rec["setup_s"], "table": rec["table"],
              "pinned_gb": rec["pinned_gb"], "prefill_tokens": rep.prefill_tokens,
              "prefill_s": rep.prefill_s, "prefill_tok_s": rep.prefill_throughput,
              "decode_tokens": rep.decode_tokens, "decode_s": rep.decode_s,
              "decode_tok_s": rep.decode_throughput,
              "server_ms_per_tick": rep.decode_s * 1e3 / max(1, ticks), "decode_ticks": ticks,
              "fused_ticks": rec["fused_ticks"], "kv_htod_gb": rep.kv_htod_gb,
              "kv_dtoh_gb": rep.kv_dtoh_bytes / 1e9, "copied_gb": rec["copied_bytes"] / 1e9,
              "demand_fetches": rec["demand_fetches"], "planned_reads": rec["planned_reads"],
              "tokens_equal_contiguous": all(same), "dropped": rep.expert_tokens_dropped,
              "launches": c})
        if len(got) != n or not all(same):
            raise AssertionError(f"serve_paged Mode {mode} {sched}: tokens differ from "
                                 f"serve_long's contiguous tokens for requests "
                                 f"{[i for i, ok in enumerate(same) if not ok]}")
        if mode == "A":
            if rec["fused_ticks"] != ticks or rep.kv_htod_bytes or c["decode_attention_paged"]:
                raise AssertionError(f"serve_paged Mode A: {rec['fused_ticks']} of {ticks} "
                                     f"ticks fused, {rep.kv_htod_bytes} KV bytes copied")
            continue
        k3p = cfg.num_layers * ticks if dev.type == "cuda" else 0
        if (rec["fused_ticks"] or c["decode_attention_paged"] != k3p
                or c["decode_attention_paged_split"] != k3p or c["decode_attention"]
                or rep.kv_htod_bytes <= 0 or host_frames <= 0):
            raise AssertionError(f"serve_paged Mode B {sched}: K3p launched "
                                 f"{c['decode_attention_paged']} times (split "
                                 f"{c['decode_attention_paged_split']}), reckoned {k3p}; "
                                 f"{rec['fused_ticks']} fused ticks")
        if dev.type == "cuda" and not all(c[k] > 0 for k in PATH_KERNELS["serve_paged"]):
            raise AssertionError(f"serve_paged: a kernel of the path was never launched: {c}")
        counts = counts or c
    # a fresh Mode B engine: the largest K3p call captured, then a chunk of
    # two ticks under the profiler, its copies held to the table's count
    before = torch.cuda.memory_allocated()
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq, device=dev,
                               cache_config=CacheConfig(page_tokens=PAGE_TOKENS,
                                                        device_pool_bytes=DEVICE_KV_GB * 1e9))
    prompts, lengths = padded_prompts(requests)
    sampler = BatchSampler.uniform(n, None)
    tok0 = sampler.sample(eng.prefill(prompts, lengths=lengths))
    with capture_calls(("decode_attention_paged",)) as dec:
        eng.decode_chunk(tok0, lengths, sampler, 1).cpu()
    steps = 2

    def chunk():
        return eng.decode_chunk(tok0, lengths + 1, sampler, steps).cpu()

    wall = host_ms(chunk) / steps

    def counters():
        eng.sync_stats()
        return eng.stats.kv_htod_bytes, eng.pages.copied_bytes

    prof, events, _, (htod0, copied0) = profiled(chunk, "serve_paged Mode B chunk",
                                                 prepare=counters)
    htod, copied = (a - b for a, b in zip(counters(), (htod0, copied0)))
    ov = stream_overlap(events)
    bytes_tick = cfg.num_layers * layer_bytes
    rec = {"phase": "profile", "what": f"serve_paged Mode B decode tick B={n}, per-module",
           "steps": steps, "wall_ms_per_tick": wall, "host_frame_gb_per_tick": bytes_tick / 1e9,
           "kv_htod_bytes_in_chunk": htod, "copied_bytes_in_chunk": copied,
           "trace_htod_bytes": ov["copy_bytes"], "copies_in_trace": ov["weight_copies"],
           "copy_gb_s": ov["copy_gb_s"], "copy_ms_per_tick": ov["copy_ms"] / steps,
           "device_kernel_ms_per_tick": ov["kernel_ms"] / steps,
           "copy_bound_ms_per_tick": (bytes_tick / (ov["copy_gb_s"] * 1e9) * 1e3
                                      if ov["copy_gb_s"] else None),
           "tick_wall_over_copy_bound": (wall / (bytes_tick / (ov["copy_gb_s"] * 1e9) * 1e3)
                                         if ov["copy_gb_s"] else None)}
    emit(rec)
    traced = ov["copy_bytes"] if dev.type == "cuda" else htod
    if not (htod == copied == traced == steps * bytes_tick):
        raise AssertionError(f"serve_paged: the table counted {htod} bytes ({copied} queued), "
                             f"the trace shows {ov['copy_bytes']}, reckoned "
                             f"{steps * bytes_tick}")
    del eng, tok0, prof
    torch.cuda.empty_cache()
    rows = check_path_kernels("serve_paged", {("decode", k): v for k, v in dec.items()})
    del dec
    freed("serve_paged", "profiled engine and its captures", before)
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 6: Mamba2-370M through K5 at every prefill layer
# ---------------------------------------------------------------------------
def phase_serve_ssm(dev, profile=False):
    """128 prompts of 200..1800 tokens, decode 64, on full-width, full-depth
    Mamba2-370M (its own seeded bf16 weights) through the port's ``Server``
    (both schedulers) at the planner's plan.  No prompt and not the wave's
    longest is a multiple of the 256-position chunk, so K5 pads the last
    chunk of every row.  K5's launches must equal layers x prefill
    micro-batches (all 128 requests form one wave under both schedulers).
    Then K5 on the inputs of its largest call on the path."""
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.weights import tree_bytes

    cfg, plan, lens, decode_len = serve_setup(ssm_lengths(), SSM_DECODE, SSM_ARCH)
    n = len(lens)
    max_seq = SSM_MAX + SSM_DECODE
    before = torch.cuda.memory_allocated()
    params = init_weights(dev, SSM_ARCH)
    nh, ns, hp, di = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_d_inner
    slot = cfg.num_layers * (nh * ns * hp * 4 + (cfg.ssm_conv_width - 1) * (di + 2 * ns) * 2)
    # reckoned before the first card run: about 40 KB of live activations a
    # position in one layer's prefill, over a micro-batch padded to the wave
    act = 40e3 * plan.b_a * SSM_MAX
    reckoning = {"weights_gb": tree_bytes(params) / 1e9, "state_gb": n * slot / 1e9,
                 "state_mb_per_slot": slot / 1e6, "prefill_activations_gb": act / 1e9,
                 "prefill_state_out_gb": plan.b_a * nh * ns * hp * 4 / 1e9, "kv_gb": 0.0}
    reckoning["total_gb"] = sum(v for k, v in reckoning.items() if k.endswith("_gb"))
    emit({"phase": "serve_ssm", "arch": cfg.name, "requests": n,
          "prompt_lens": [min(lens), max(lens)], "prompt_tokens": sum(lens),
          "decode_len": decode_len, "max_seq": max_seq,
          "plan": {"B": plan.B, "b_a": plan.b_a, "b_e": plan.b_e},
          "memory_reckoning": reckoning})
    requests = synthetic_requests(DatasetSpec("ssm", n, SSM_MAX, decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    _, reports, counts = serve_both(dev, cfg, params, plan, requests, decode_len,
                                    "serve_ssm")
    emit({"phase": "serve_ssm", "reckoned_gb": reckoning["total_gb"],
          "peak_gb_continuous": torch.cuda.max_memory_allocated() / 1e9})
    want = cfg.num_layers * -(-n // plan.b_a)
    for sched, c in counts.items():
        emit({"phase": "serve_ssm", "scheduler": sched,
              "k5_launches": c["ssd_scan"], "k5_expected": want})
        if dev.type == "cuda" and (c["ssd_scan"] != want or want <= 0):
            raise AssertionError(f"{sched}: K5 launched {c['ssd_scan']} times, "
                                 f"expected {want}")
    profile_path(dev, "serve_ssm", cfg, params, plan, requests, max_seq, reports,
                 profile)
    del params
    freed("serve_ssm", "Mamba2 weights", before)
    torch.cuda.empty_cache()
    return counts["static"], reports


# ---------------------------------------------------------------------------
# Phase 7: weight streaming, OLMoE against its resident tokens
# ---------------------------------------------------------------------------
STREAMED_BUDGET = 7e9          # OLMoE-1B-7B: the expert stacks of layers 7-15 stream
# Mixtral-8x7B: 60 GB resident (base, all 32 mixers, the stacks of layers
# 0-19); the stacks of layers 20-31 stream.  64 prompts of 128..512, decode 16
MIXTRAL_ARCH, MIXTRAL_BUDGET = "mixtral-8x7b", 60e9
MIXTRAL_REQUESTS, MIXTRAL_MIN, MIXTRAL_MAX, MIXTRAL_DECODE = 64, 128, 512, 16
K1K2_KERNELS = ("gate_up_wgmma_kernel", "gemm_wgmma_kernel")


def mixtral_lengths(n: int = MIXTRAL_REQUESTS):
    return [MIXTRAL_MIN + ((MIXTRAL_MAX - MIXTRAL_MIN) * i) // (n - 1) for i in range(n)]


def host_meminfo() -> dict:
    """The card's host memory, GB, from ``/proc/meminfo``."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[f"{key}_gb"] = int(val.split()[0]) * 1024 / 1e9
    return out


def streamed_run(dev, cfg, params, plan, requests, decode_len: int, phase: str,
                 sched: str, stream=None, store=None) -> dict:
    """One streamed Server run: ``stream`` (a ``StreamConfig``) has the
    server build its store from ``params``, or ``store`` is a built one.
    The launch counts are set to 0 just before the run and read just after;
    prefill passes are counted.  The deleted server must free its device
    bytes and, when it built the store, its page-locked host bytes."""
    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server, StreamConfig

    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    server = Server(cfg, params, plan, serve=ServeConfig(scheduler=sched, decode_len=decode_len),
                    stream=stream if stream is not None else StreamConfig(), store=store,
                    device=dev)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    eng, waves = server._engine, [0]
    copied = server._store.copied_bytes
    real = eng.prefill_slots

    def counted(*a, **kw):
        waves[0] += 1
        return real(*a, **kw)

    eng.prefill_slots = counted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del eng.prefill_slots, real, counted     # (the wrapper held the engine)
    st, built = eng.stats, server._store
    rec = {"report": rep, "counts": counts, "waves": waves[0],
           "ticks": rep.decode_slot_steps // server._b, "wall_s": wall,
           "streamed_bytes": built.streamed_module_bytes(),
           "streamed_padded_bytes": sum(h.layout.size for h in built._host if h is not None),
           "copied_bytes": built.copied_bytes - copied, "predict_topk": built.predict_topk,
           "prefetch_issued": st.prefetch_issued, "demand_fetches": st.demand_fetches,
           "planned_reads": st.planned_reads, "pinned_gb": wmod.pinned_bytes() / 1e9,
           "fused_ticks": st.fused_ticks}
    del server, eng, st, built
    freed(phase, f"{sched} streamed server", before)
    if stream is not None and wmod.pinned_bytes() != pinned:
        raise AssertionError(f"{phase}: the deleted server left "
                             f"{wmod.pinned_bytes() - pinned} page-locked bytes")
    return rec


def check_streamed(phase: str, sched: str, rec: dict, want_tokens, decode_len: int,
                   want_counts=None) -> dict:
    """A streamed run's checks: every request served with ``decode_len``
    tokens equal to ``want_tokens`` (the resident run's), no routed copy
    dropped, no decode tick fused, every kernel of the path launched in its
    new design, and (when given) the same launch counts as the resident
    run.  With whole stacks, the htod bytes and the bytes really copied are
    those the plan gives: every streamed stack once a prefill wave and a
    decode tick.  Per-expert copies depend on the routing; they are held to
    the profiler trace's copies in ``streamed_profile``.  Returns the
    printed record."""
    import numpy as np

    rep, counts = rec["report"], rec["counts"]
    got = [r.tokens for r in rep.request_results]
    passes = rec["waves"] + rec["ticks"]
    whole = rec["predict_topk"] == 0
    reckoned = (passes * rec["streamed_bytes"], passes * rec["streamed_padded_bytes"])
    out = {"phase": phase, "scheduler": sched, "wall_s": rec["wall_s"],
           "prefill_tokens": rep.prefill_tokens, "prefill_s": rep.prefill_s,
           "prefill_tok_s": rep.prefill_throughput, "decode_tokens": rep.decode_tokens,
           "decode_s": rep.decode_s, "decode_tok_s": rep.decode_throughput,
           "server_ms_per_tick": rep.decode_s * 1e3 / max(1, rec["ticks"]),
           "prefill_waves": rec["waves"], "decode_ticks": rec["ticks"],
           "htod_gb": rep.htod_gb,
           "htod_reckoned_gb": reckoned[0] / 1e9 if whole else None,
           "htod_gb_per_pass": rep.htod_gb / max(1, passes),
           "copied_gb": rec["copied_bytes"] / 1e9,
           "copied_reckoned_gb": reckoned[1] / 1e9 if whole else None,
           "prefetch_wait_s": rep.prefetch_wait_s,
           "prefetch_issued": rec["prefetch_issued"], "demand_fetches": rec["demand_fetches"],
           "expert_pred_hits": rep.expert_pred_hits,
           "expert_pred_misses": rep.expert_pred_misses,
           "expert_lru_hits": rep.expert_lru_hits, "pred_hit_rate": rep.pred_hit_rate,
           "lru_hit_rate": rep.lru_hit_rate, "planned_reads": rec["planned_reads"],
           "pinned_gb": rec["pinned_gb"], "dropped": rep.expert_tokens_dropped,
           "launches": counts}
    emit(out)
    if len(got) != len(want_tokens) or any(t.size != decode_len for t in got):
        raise AssertionError(f"{phase} {sched}: wrong number of tokens served")
    for i, (a, b) in enumerate(zip(got, want_tokens)):
        if not np.array_equal(a, b):
            step = int(np.flatnonzero(a != b)[0]) if a.shape == b.shape else -1
            raise AssertionError(f"{phase} {sched}: request {i} differs from the resident "
                                 f"tokens, first at step {step}")
    if rep.expert_tokens_dropped or rec["fused_ticks"]:
        raise AssertionError(f"{phase} {sched}: {rep.expert_tokens_dropped} copies "
                             f"dropped, {rec['fused_ticks']} fused ticks")
    if whole and (rep.weight_htod_bytes, rec["copied_bytes"]) != reckoned:
        raise AssertionError(f"{phase} {sched}: {rep.weight_htod_bytes} htod bytes and "
                             f"{rec['copied_bytes']} copied, {reckoned} reckoned")
    on_card = rec["report"] is not None and torch.cuda.is_available()
    if on_card and not all(counts[k] > 0 for k in PATH_KERNELS[phase]):
        raise AssertionError(f"{phase} {sched}: a kernel of the path was never launched: "
                             f"{counts}")
    if on_card and any(counts[k] != counts[f"{k}_{d}"] for k, d in NEW_DESIGNS):
        raise AssertionError(f"{phase} {sched}: a launch did not take its new design: "
                             f"{counts}")
    if want_counts is not None and counts != want_counts:
        raise AssertionError(f"{phase} {sched}: launch counts {counts} differ from the "
                             f"resident run's {want_counts}")
    return out


def stream_overlap(events) -> dict:
    """From a torch.profiler trace's events: the device time of the weight
    copies (host-to-device copies of 1 MB or more) and of K1/K2, the streams
    each ran on, the copies' bandwidth, and the time K1/K2 ran while a copy
    was in flight."""
    copies, gemms, kernel_us = [], [], 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args, cat, nm = ev.get("args", {}), ev.get("cat", ""), ev.get("name", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
                args.get("stream"), float(args.get("bytes", 0)))
        if cat == "gpu_memcpy" and "HtoD" in nm and span[3] >= 1 << 20:
            copies.append(span)
        elif cat == "kernel":
            kernel_us += span[1] - span[0]
            if any(k in nm for k in K1K2_KERNELS):
                gemms.append(span)
    copy_us = sum(e - b for b, e, _, _ in copies)
    gemm_us = sum(e - b for b, e, _, _ in gemms)
    overlap_us = sum(max(0.0, min(e1, e2) - max(b1, b2))
                     for b1, e1, _, _ in copies for b2, e2, _, _ in gemms)
    nbytes = sum(c[3] for c in copies)
    return {"kernel_ms": kernel_us / 1e3,
            "weight_copies": len(copies), "copy_ms": copy_us / 1e3,
            "copy_bytes": int(nbytes), "copy_gb": nbytes / 1e9,
            "copy_gb_s": nbytes / (copy_us / 1e6) / 1e9 if copy_us else 0.0,
            "copy_streams": sorted({str(c[2]) for c in copies}),
            "k1k2_launches": len(gemms), "k1k2_ms": gemm_us / 1e3,
            "k1k2_streams": sorted({str(g[2]) for g in gemms}),
            "k1k2_ms_during_copies": overlap_us / 1e3,
            "k1k2_share_during_copies": overlap_us / gemm_us if gemm_us else 0.0}


def streamed_profile(dev, phase: str, cfg, params, plan, requests, max_seq: int,
                     store, steps: int = 2, capture: bool = True):
    """A fresh engine over ``store``: a prefill of the prompts and ``steps``
    per-module ticks with the kernels' largest calls captured (K1/K2 only
    where they read streamed weights, out of a window slot or the expert
    stacks), then ``steps`` ticks under torch.profiler (copies against
    K1/K2, ``stream_overlap``: with whole stacks K1/K2 must run while a
    copy is in flight, on another stream), the wall of a chunk with its
    token read, and the sync sites of a chunk: none, the predictive reads
    being planned and counted.  Returns (captured calls, the record)."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.sampling import BatchSampler

    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq, store=store, device=dev)
    prompts, lengths = padded_prompts(requests)
    sampler = BatchSampler.uniform(len(requests), None)
    streamed = {t.untyped_storage().data_ptr() for t in store._window._slots}
    streamed |= {t.untyped_storage().data_ptr() for t in store._stack.values()}

    def keep(name, args):
        return name != "grouped_expert_ffn" or args[1].untyped_storage().data_ptr() in streamed

    names = ("grouped_expert_ffn", "flash_attention") if capture else ()
    with capture_calls(names, keep) as pre:
        tok0 = sampler.sample(eng.prefill(prompts, lengths=lengths))
    names = ("grouped_expert_ffn", "decode_attention") if capture else ()
    with capture_calls(names, keep) as dec:
        eng.decode_chunk(tok0, lengths, sampler, steps).cpu()

    def chunk():
        return eng.decode_chunk(tok0, lengths, sampler, steps)

    n_pred = sum(store.streams_experts(li) for li in range(cfg.num_layers))
    wall = host_ms(lambda: chunk().cpu()) / steps
    reads = eng.stats.planned_reads
    hidden = sync_sites(chunk)
    reads = eng.stats.planned_reads - reads
    _, events, _, copied = profiled(lambda: chunk().cpu(), f"{phase} streamed chunk",
                                    prepare=lambda: store.copied_bytes)
    copied = store.copied_bytes - copied
    ov = stream_overlap(events)
    rec = {"phase": "profile", "what": f"{phase} streamed decode tick B={len(requests)}, "
           f"per-module, predict_topk={store.predict_topk}", "steps": steps,
           "wall_ms_per_tick": wall,
           "streamed_gb_per_tick": store.streamed_module_bytes() / 1e9,
           **{k: v / steps if k.endswith("_ms") else v for k, v in ov.items()},
           "sync_sites_in_chunk": hidden, "planned_reads_in_chunk": reads,
           "planned_reads_expected": steps * n_pred,
           "prefetch_depth": store.prefetch_depth, "copied_bytes_in_chunk": copied}
    if ov["copy_gb_s"]:
        rec["tick_wall_over_bytes_per_bw"] = wall / (
            store.streamed_module_bytes() / (ov["copy_gb_s"] * 1e9) * 1e3)
    emit(rec)
    if hidden:
        raise AssertionError(f"{phase}: host syncs inside a streamed decode chunk: {hidden}")
    if reads != steps * n_pred:
        raise AssertionError(f"{phase}: {reads} planned reads in {steps} ticks, expected "
                             f"{steps * n_pred}")
    # the bytes the store says it queued are those the card copied host to
    # device, as its trace records them (every weight copy is 1 MB or more)
    if dev.type == "cuda" and copied != ov["copy_bytes"]:
        raise AssertionError(f"{phase}: the store queued {copied} bytes of weight copies "
                             f"in the chunk, the trace shows {ov['copy_bytes']}")
    # whole stacks: a layer's copy is issued a layer ahead and must run under
    # K1/K2.  Per-expert copies are issued one by one after the layer's
    # planned read, and may all land before the host reaches K1/K2
    overlap = ov["k1k2_ms_during_copies"] > 0 or store.predict_topk > 0
    if dev.type == "cuda" and not (
            ov["weight_copies"] and overlap
            and set(ov["copy_streams"]).isdisjoint(ov["k1k2_streams"])):
        raise AssertionError(f"{phase}: K1/K2 do not overlap the weight copies on a stream "
                             f"of their own: {ov}")
    del eng
    calls = {("prefill", k): v for k, v in pre.items()}
    calls.update({("decode", k): v for k, v in dec.items()})
    return calls, rec


def phase_serve_streamed(dev, params, resident=None):
    """OLMoE-1B-7B on the serve phase's 64 requests and weights, with
    ``resident_bytes`` 7 GB: the expert stacks of layers 7-15 in page-locked
    host memory.  Whole-stack streaming, then predictive streaming at
    ``predict_topk`` 8, each under both schedulers: tokens equal to the
    resident ``serve`` tokens bit for bit (``resident``: that phase's
    (counts, reports); run here when the phase did not), launch counts
    equal to the resident run's, with whole stacks the htod bytes and the
    bytes copied as reckoned (9 stacks a prefill wave and a decode tick).
    Then the streamed tick's profile for each (the experts copied held to
    the trace's copies), and K1/K2 held to their plain versions on calls
    that read streamed weights: out of a window slot, and out of the
    per-expert stacks the expert window fills."""
    from repro_torch.core import workload as W
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.server import StreamConfig

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    n = len(lens)
    requests = synthetic_requests(DatasetSpec("smoke", n, max(lens), decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    if resident is None:
        counts, reports = {}, {}
        for sched in ("static", "continuous"):
            rec = streamed_run(dev, cfg, params, plan, requests, decode_len,
                               "serve_streamed", sched)
            counts[sched], reports[sched] = rec["counts"], rec["report"]
        resident = (counts, reports)
    want = [r.tokens for r in resident[1]["static"].request_results]
    rp = W.plan_residency(cfg, STREAMED_BUDGET)
    layers = [i for i, r in enumerate(rp.ffn_resident) if not r]
    emit({"phase": "serve_streamed", "resident_bytes": STREAMED_BUDGET,
          "resident_gb": rp.resident_bytes / 1e9, "streamed_stack_layers": layers,
          "streamed_gb": len(layers) * W.ffn_module_weight_bytes(cfg, "moe") / 1e9,
          "host": host_meminfo()})
    first = None
    for khat in (0, 8):
        stream = StreamConfig(stream_weights=True, resident_bytes=STREAMED_BUDGET,
                              predict_topk=khat)
        for sched in ("static", "continuous"):
            rec = streamed_run(dev, cfg, params, plan, requests, decode_len,
                               "serve_streamed", sched, stream=stream)
            out = check_streamed("serve_streamed", sched, rec, want, decode_len,
                                 resident[0][sched])
            out["predict_topk"] = khat
            first = first or rec["counts"]
    rows = []
    from repro_torch.serving.weights import ParamStore

    for khat in (0, 8):
        before = torch.cuda.memory_allocated()
        store = ParamStore.build(cfg, params, plan, stream_weights=True,
                                 resident_bytes=STREAMED_BUDGET, predict_topk=khat,
                                 device=dev)
        calls, _ = streamed_profile(dev, "serve_streamed", cfg, None, plan, requests,
                                    max(lens) + decode_len, store)
        del store
        got = check_path_kernels("serve_streamed" + ("-expert-window" if khat else ""),
                                 calls)
        rows += got
        del calls, got
        freed("serve_streamed", f"profiled store (predict_topk {khat}) and its captures",
              before)
    return first, rows


# ---------------------------------------------------------------------------
# Fault injection and the sanitizer on the streamed and paged paths
# ---------------------------------------------------------------------------
# serve_faults: serve_streamed's whole-stack run under injected transient
# copy failures and stalls, then serve_paged's Mode B run under injected
# page-frame OOMs and a preemption every 8 decode ticks (continuous
# scheduler), both under the strict sanitizer with the pointer check; the
# OOM-deferred admission waves are served again fault-free as witnesses
FAULTS_STREAMED = "seed=7,transfer=0.05,stall=0.02"
FAULTS_PAGED_OOM, FAULTS_PAGED = "seed=7,oom=0.05", "seed=7,oom=0.05,preempt=8"


def faults_run(dev, phase: str, server, half_ticks: int, midway=None) -> dict:
    """Drive ``server`` (its requests submitted) step by step under
    ``sanitize(strict=True, pointers=True)``, with a ``steady()`` region from
    decode tick ``half_ticks`` on; ``midway(server)`` runs once at that
    point.  Launch counts set to 0 just before, read just after."""
    from repro_torch import analysis
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with analysis.sanitize(strict=True, pointers=True) as san:
        with contextlib.ExitStack() as stack:
            steady = False
            while server.step():
                if not steady and server._ticks >= half_ticks:
                    if midway is not None:
                        midway(server)
                    stack.enter_context(san.steady())
                    steady = True
        rep = server.finalize()
    torch.cuda.synchronize()
    return {"report": rep, "counts": ops.launch_counts(), "handles": list(server._handles),
            "wall_s": time.perf_counter() - t0, "sanitizer": san.report()}


def check_faults_run(phase: str, run: str, rec: dict, want_tokens, ledger: dict,
                     kinds, kernels) -> None:
    """Tokens identical to the oracle's (``want_tokens``), every injected
    kind injected and recovered, no sanitizer finding, every kernel of the
    path launched."""
    import numpy as np

    rep, san = rec["report"], rec["sanitizer"]
    got = [r.tokens for r in rep.request_results]
    same = [bool(np.array_equal(a, b)) for a, b in zip(got, want_tokens)]
    if len(got) != len(want_tokens) or not all(same):
        raise AssertionError(f"{phase} {run}: tokens differ from the fault-free oracle for "
                             f"requests {[i for i, ok in enumerate(same) if not ok]}")
    for injected, recovered in kinds:
        if not any(k.startswith(injected) for k in ledger) or not any(
                k.startswith(recovered) for k in ledger):
            raise AssertionError(f"{phase} {run}: {injected} not injected and recovered: "
                                 f"{ledger}")
    if san["host_reads"] or san["pointer_violations"] or san["steady_retraces"]:
        raise AssertionError(f"{phase} {run}: sanitizer findings {san}")
    c = rec["counts"]
    if torch.cuda.is_available() and not all(c[k] > 0 for k in kernels):
        raise AssertionError(f"{phase} {run}: a kernel of the path was never launched: {c}")


def sanitizer_cost(dev, cfg, params, plan, requests, max_seq: int, T: int = 8) -> dict:
    """The sanitizer's cost per decode tick: the same chunk of ``T`` ticks
    unarmed and under ``sanitize(strict=True, pointers=True)``, in turns
    (unarmed, armed, armed, unarmed), on the fused graph and on the
    per-module path."""
    from repro_torch import analysis
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.sampling import BatchSampler

    prompts, lengths = padded_prompts(requests)
    out = {}
    for path, fused in (("fused", True), ("per-module", False)):
        before = torch.cuda.memory_allocated()
        eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq, device=dev,
                                   fused_decode=fused)
        sampler = BatchSampler.uniform(len(requests), None)
        tok0 = sampler.sample(eng.prefill(prompts, lengths=lengths))
        eng.decode_chunk(tok0, lengths, sampler, T).cpu()          # captures
        ms = {"unarmed": [], "armed": []}
        for armed in (False, True, True, False):
            ctx = (analysis.sanitize(strict=True, pointers=True) if armed
                   else contextlib.nullcontext())
            with ctx:
                ms["armed" if armed else "unarmed"].append(host_ms(
                    lambda: eng.decode_chunk(tok0, lengths, sampler, T).cpu()) / T)
        out[path] = {"unarmed_ms_per_tick": ms["unarmed"], "armed_ms_per_tick": ms["armed"],
                     "cost_ms_per_tick": (sum(ms["armed"]) - sum(ms["unarmed"])) / 2}
        del eng, tok0, sampler
        freed("serve_faults", f"{path} sanitizer-cost engine", before)
    return out


def paged_serve_kw(decode_len: int) -> dict:
    """serve_paged's Mode B knobs under the continuous scheduler."""
    return {"scheduler": "continuous", "decode_len": decode_len, "kv_page_tokens": PAGE_TOKENS,
            "device_kv_gb": DEVICE_KV_GB}


def paged_faults_run(dev, cfg, params, plan, requests, decode_len: int, spec: str,
                     midway: bool) -> dict:
    """serve_paged's Mode B server (continuous) under the fault plan ``spec``,
    driven by ``faults_run``; with ``midway``, once at the middle of decode
    a public preemption of the highest live slot (its frames are host
    frames) and a demotion of live device frames into the frames it freed
    (its host wall: the demotion waits for its copies).  The deleted server
    must free its device and page-locked bytes."""
    from repro_torch import faults
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server

    fp = faults.resolve(spec)
    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    server = Server(cfg, params, plan, serve=ServeConfig(faults=fp, **paged_serve_kw(decode_len)),
                    device=dev)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    pages = server._engine.pages
    mid = {}

    def halfway(srv):
        with faults.armed(fp):
            slot = max(s for s in range(srv._b) if srv._slot_handle[s] is not None)
            mid["preempted"] = srv.preempt(srv._slot_handle[slot])
            t0 = time.perf_counter()
            mid["demoted_frames"] = pages.demote_device_frames(pages.pages_per_seq)
            mid["demote_host_s"] = time.perf_counter() - t0

    rec = faults_run(dev, "serve_faults", server, (decode_len - 1) // 2,
                     halfway if midway else None)
    rep = rec["report"]
    rec.update(midway=mid, ledger=fp.report()["events"])
    emit({"phase": "serve_faults", "run": "paged" if midway else "paged-oom", "faults": spec,
          "wall_s": rec["wall_s"], "decode_s": rep.decode_s,
          "decode_tok_s": rep.decode_throughput, "prefill_s": rep.prefill_s,
          "preemptions": rep.preemptions, "resumes": rep.resumes,
          "degrade_deferrals": rep.degrade_deferrals, "page_demotions": rep.page_demotions,
          "chunk_shrinks": rep.chunk_shrinks, "ledger": rec["ledger"],
          "admission_waves": rep.admission_waves,
          "planned_reads_by_tag": rec["sanitizer"]["planned_transfers"],
          "pointer_checks": rec["sanitizer"]["pointer_checks"], "midway": mid,
          "demoted_gb": mid.get("demoted_frames", 0) * pages.frame_bytes / 1e9,
          "checkpoints": rep.preemptions, "checkpoint_gb": rep.checkpoint_bytes / 1e9,
          "checkpoint_mb_each": rep.checkpoint_bytes / 1e6 / max(1, rep.preemptions),
          "checkpoint_host_s": rep.checkpoint_s, "restore_host_s": rep.restore_s,
          "kv_dtoh_gb": rep.kv_dtoh_bytes / 1e9, "launches": rec["counts"],
          "card": gpu_line()})
    del server, pages
    freed("serve_faults", f"{spec} paged server", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError("serve_faults: a paged server left page-locked bytes")
    return rec


def wave_witness(dev, cfg, params, plan, requests, serve_kw: dict, waves,
                 phase: str = "serve_faults", max_batch=None) -> dict:
    """A fault-free witness of an OOM-deferred run (or of one replica of a
    fleet): ``requests`` served with ``serve_kw`` (one decode tick a step),
    each admission wave of ``waves`` ((decode tick, request indices), as
    ``ServeReport.admission_waves`` records them) submitted just before the
    step at its tick, so that it is admitted then, in one prefill, beside
    the rows already decoding; ``max_batch`` engine slots (default: one a
    request).  Fails unless the witness's own waves are those."""
    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server

    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    kw = dict(serve_kw, decode_chunk=1, max_batch=max_batch or len(requests))
    kw.setdefault("max_seq", max(len(r.prompt) for r in requests) + serve_kw["decode_len"])
    server = Server(cfg, params, plan, serve=ServeConfig(**kw), device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0, steps = time.perf_counter(), 0
    for tick, idx in waves:
        while steps < tick and server.step():
            steps += 1
        for i in idx:
            server.submit(requests[i])
    rep = server.run()
    torch.cuda.synchronize()
    rec = {"report": rep, "counts": ops.launch_counts(), "wall_s": time.perf_counter() - t0,
           "tokens": [r.tokens for r in rep.request_results]}
    del server
    freed(phase, "witness server", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError(f"{phase}: a witness server left page-locked bytes")
    if [list(w) for w in rep.admission_waves] != [list(w) for w in waves]:
        raise AssertionError(f"{phase}: the witness was admitted in "
                             f"{rep.admission_waves}, not in {waves}")
    return rec


def wave_prefill_logits(dev, cfg, params, plan, requests, waves) -> tuple:
    """Each request's first-token logits (f32 on the host), prefilled as the
    server prefills a wave (right-padded to the wave's longest prompt), by
    one engine: (one) all requests in one wave, serve_long's static wave;
    (split) in ``waves``; (offset) each wave behind the prompts of every
    earlier wave, so that its rows sit at their offsets of the one wave,
    their rows kept.  Returns the three (n, V)."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.server import pad_requests

    before = torch.cuda.memory_allocated()
    n = len(requests)
    eng = ModuleBatchingEngine(cfg, params, plan, device=dev,
                               max_seq=max(len(r.prompt) for r in requests) + LONG_DECODE)
    eng.init_cache(n)
    out, done = [], []
    groups = {"one": [(list(range(n)), list(range(n)))],
              "split": [(idx, idx) for _, idx in waves], "offset": []}
    for _, idx in waves:
        done += idx
        groups["offset"].append((list(done), idx))
    for name in ("one", "split", "offset"):
        lg = torch.empty((n, cfg.vocab_size), dtype=torch.float32)
        for rows, keep in groups[name]:
            toks, lens = pad_requests([requests[i] for i in rows])
            got = eng.prefill_slots(toks, rows, lengths=lens).float().cpu()
            lg[keep] = got[[rows.index(i) for i in keep]]
        out.append(lg)
    del eng
    freed("serve_faults", "prefill-logits engine", before)
    return tuple(out)


def phase_serve_faults(dev, params, resident=None, long_reports=None):
    """The faults slice on the card at full width and depth (OLMoE-1B-7B,
    bf16), the fault runs under the strict sanitizer with the pointer check
    and a steady region over the second half of each decode:

    1. serve_streamed's 64 requests and residency (the expert stacks of
       layers 7-15 page-locked), whole stacks, static, with transient copy
       failures and stalls injected (``FAULTS_STREAMED``): held to the
       resident tokens serve_streamed is held to (``resident``: serve's
       (counts, reports); run here when absent);
    2. serve_paged's Mode B requests (serve_long's 32 prompts, 7.5 GB of
       device frames), continuous: (2a) with page-frame OOMs injected
       (``FAULTS_PAGED_OOM``), then (2b) with the same OOMs, a preemption
       every 8 decode ticks (``FAULTS_PAGED``) and once, midway, a public
       ``preempt`` of the highest slot followed by a demotion of live
       device frames into the host frames it freed.  An OOM defers an
       admission, which splits the prefill into waves admitted while the
       earlier waves decode.  Two fault-free witnesses serve the same
       requests in 2a's recorded waves, at its ticks: (W1) Mode B, (W2)
       the contiguous cache, no page table and no KV copy stream.  2a, 2b
       and W2 must equal W1 bit for bit.  Against serve_long's one wave
       (``long_reports``; run here when absent) the share of equal
       requests is printed.  Each request's first-token logits are
       prefilled three ways: in one wave (which must give serve_long's
       first tokens), in 2a's waves (the first wave must be bit-identical
       to one wave, the later waves' median within the bf16 row
       tolerance), and each wave behind the earlier waves' prompts, at
       its rows' offsets of the one wave (bit-identical to one wave).

    Each fault run fails unless its tokens equal its oracle's, every
    injected kind was injected and recovered (the plan's ledger and the
    report's counters), the sanitizer found nothing, and every kernel of
    the path launched.  Prints the planned reads by tag, what recovery
    cost (bytes copied again, checkpointed and demoted, with their host
    wall) and the sanitizer's cost per tick, armed against unarmed, fused
    and per module."""
    import numpy as np

    from repro_torch import faults
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig, Server, StreamConfig

    # -- run 1: streamed weights, transfer failures and stalls -------------
    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    n = len(lens)
    requests = synthetic_requests(DatasetSpec("smoke", n, max(lens), decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    if resident is None:
        rec = streamed_run(dev, cfg, params, plan, requests, decode_len, "serve_faults",
                           "static")
        resident = ({"static": rec["counts"]}, {"static": rec["report"]})
    want = [r.tokens for r in resident[1]["static"].request_results]
    launches = {}
    plan_1 = faults.resolve(FAULTS_STREAMED)
    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    server = Server(cfg, params, plan, serve=ServeConfig(scheduler="static",
                                                         decode_len=decode_len,
                                                         faults=plan_1),
                    stream=StreamConfig(stream_weights=True, resident_bytes=STREAMED_BUDGET,
                                        predict_topk=0), device=dev)
    for r in requests:
        server.submit(r)
    server._ensure_engine()
    store = server._store
    rec = faults_run(dev, "serve_faults", server, (decode_len - 1) // 2)
    rep = rec["report"]
    passes = 1 + rep.decode_slot_steps // server._b            # one wave, its ticks
    padded = sum(h.layout.size for h in store._host if h is not None)
    recopied = store.copied_bytes - passes * padded
    emit({"phase": "serve_faults", "run": "streamed", "faults": FAULTS_STREAMED,
          "wall_s": rec["wall_s"], "decode_s": rep.decode_s,
          "decode_tok_s": rep.decode_throughput, "prefill_s": rep.prefill_s,
          "transfer_retries": rep.transfer_retries, "transfer_timeouts": rep.transfer_timeouts,
          "ledger": plan_1.report()["events"],
          "planned_reads_by_tag": rec["sanitizer"]["planned_transfers"],
          "pointer_checks": rec["sanitizer"]["pointer_checks"],
          "copied_gb": store.copied_bytes / 1e9, "recopied_gb": recopied / 1e9,
          "recopied_stacks": recopied / max(1, padded // 9), "launches": rec["counts"],
          "card": gpu_line()})
    check_faults_run("serve_faults", "streamed", rec, want, plan_1.report()["events"],
                     (("injected:transfer", "recovered:transfer-retry"),
                      ("injected:stall", "recovered:transfer-timeout")),
                     PATH_KERNELS["serve_streamed"])
    if rep.transfer_retries <= 0 or rep.transfer_timeouts <= 0:
        raise AssertionError(f"serve_faults streamed: {rep.transfer_retries} retries, "
                             f"{rep.transfer_timeouts} timeouts counted")
    launches["streamed"] = rec["counts"]
    del server, store, rec, rep
    freed("serve_faults", "streamed faulted server", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError("serve_faults: the streamed server left page-locked bytes")

    # -- runs 2a and 2b: Mode B pages, page OOMs, then preemptions too -----
    cfg, plan, lens, decode_len = serve_setup(long_lengths(), LONG_DECODE)
    n = len(lens)
    requests = synthetic_requests(DatasetSpec("long", n, LONG_MAX, decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    if long_reports is None:
        long_reports = {"static": paged_run(dev, cfg, params, plan, requests, decode_len,
                                            "static", {})["report"]}
    long_tokens = [r.tokens for r in long_reports["static"].request_results]
    a = paged_faults_run(dev, cfg, params, plan, requests, decode_len, FAULTS_PAGED_OOM,
                         midway=False)
    waves = a["report"].admission_waves
    # the witnesses: 2a's waves at its ticks, fault-free, Mode B then the
    # contiguous cache
    w1 = wave_witness(dev, cfg, params, plan, requests, paged_serve_kw(decode_len), waves)
    w2 = wave_witness(dev, cfg, params, plan, requests,
                      {"scheduler": "continuous", "decode_len": decode_len}, waves)
    one, split, offset = wave_prefill_logits(dev, cfg, params, plan, requests, waves)
    rel = [errors(split[i][None], one[i][None])[1] for i in range(n)]
    later = [i for _, idx in waves[1:] for i in idx]
    at_offset = [bool(torch.equal(offset[i], one[i])) for i in range(n)]
    toks_a = [r.tokens for r in a["report"].request_results]
    same = {name: [bool(np.array_equal(x, y)) for x, y in zip(toks, w1["tokens"])]
            for name, toks in (("paged-oom", toks_a), ("witness-contiguous", w2["tokens"]))}
    same_long = [bool(np.array_equal(x, y)) for x, y in zip(w1["tokens"], long_tokens)]
    emit({"phase": "serve_faults", "run": "witnesses", "admission_waves": waves,
          "paged_oom_equal_witness": sum(same["paged-oom"]),
          "contiguous_witness_equal_witness": sum(same["witness-contiguous"]),
          "witness_equal_serve_long": same_long,
          "requests_equal_serve_long": sum(same_long),
          "first_logits_bit_identical_to_one_wave": [r == 0.0 for r in rel],
          "first_logits_rel_err": rel, "tolerance": REL_BF16,
          "later_waves_rel_err_median": float(np.median([rel[i] for i in later] or [0.0])),
          "later_waves_rel_err_max": max([rel[i] for i in later] or [0.0]),
          "first_logits_at_one_wave_offsets_bit_identical": at_offset,
          "first_tokens_equal_serve_long": sum(int(one[i].argmax()) == int(long_tokens[i][0])
                                               for i in range(n)),
          "witness_wall_s": [w1["wall_s"], w2["wall_s"]],
          "witness_launches": [w1["counts"], w2["counts"]], "card": gpu_line()})
    for name, ok in same.items():
        if not all(ok):
            raise AssertionError(f"serve_faults: {name} tokens differ from the fault-free "
                                 f"Mode B witness (2a's waves) for requests "
                                 f"{[i for i, x in enumerate(ok) if not x]}")
    if any(int(one[i].argmax()) != int(long_tokens[i][0]) for i in range(n)):
        raise AssertionError("serve_faults: one wave's prefill disagrees with serve_long's "
                             "first tokens")
    # where a row sits in its prefill batch sets its bits: the first wave
    # (the one wave's offsets) and every row prefilled behind the earlier
    # waves' prompts must be bit-identical to the one wave; rows prefilled
    # at other offsets differ by bf16 rounding and the routing near-ties
    # it tips, as prefix hits do (serve_prefix): median within the row
    # tolerance
    moved = [i for i in range(n) if not at_offset[i] or (i in waves[0][1] and rel[i] != 0.0)]
    med = float(np.median([rel[i] for i in later] or [0.0]))
    if moved or med >= REL_BF16:
        raise AssertionError(f"serve_faults: first-token logits at the one wave's offsets not "
                             f"bit-identical for requests {moved}, or the later waves' median "
                             f"{med} of the row peak off one wave's (within {REL_BF16} expected)")
    check_faults_run("serve_faults", "paged-oom", a, w1["tokens"], a["ledger"],
                     (("injected:page-oom", "recovered:admission-deferral"),),
                     PATH_KERNELS["serve_paged"])
    b = paged_faults_run(dev, cfg, params, plan, requests, decode_len, FAULTS_PAGED,
                         midway=True)
    # preemption starts after every admission: 2b has 2a's waves
    if b["report"].admission_waves != waves:
        raise AssertionError(f"serve_faults: the paged runs' admission waves differ: "
                             f"{waves} against {b['report'].admission_waves}")
    check_faults_run("serve_faults", "paged", b, w1["tokens"], b["ledger"],
                     (("injected:page-oom", "recovered:admission-deferral"),
                      ("injected:preempt", "resume")),
                     PATH_KERNELS["serve_paged"])
    rep, mid = b["report"], b["midway"]
    if (rep.preemptions < 2 or rep.resumes != rep.preemptions or rep.degrade_deferrals <= 0
            or not mid.get("preempted") or not mid.get("demoted_frames")):
        raise AssertionError(f"serve_faults paged: {rep.preemptions} preemptions, "
                             f"{rep.resumes} resumes, {rep.degrade_deferrals} deferrals, "
                             f"midway {mid}")
    launches["paged"] = b["counts"]
    del a, b, w1, w2, rep

    # -- the sanitizer's cost per tick ---------------------------------------
    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    requests = synthetic_requests(DatasetSpec("smoke", len(lens), max(lens), decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    emit({"phase": "serve_faults", "sanitizer_cost": sanitizer_cost(
        dev, cfg, params, plan, requests, max(lens) + decode_len), "card": gpu_line()})
    return launches


# ---------------------------------------------------------------------------
# Phase 8: full-width, full-depth Mixtral-8x7B with 12 expert stacks streamed
# ---------------------------------------------------------------------------
def mixtral_parity(dev):
    """Mixtral at full width but 2 layers, f32, the stack of layer 1
    streamed through the window: the card's engine (kernels) against the
    CPU's (plain versions, every weight resident) on a ragged batch,
    prefill and 3 decode steps: logits within 1e-3 of their scale, the
    same greedy tokens, K1-K4 launched on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import workload as W
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.weights import ParamStore

    torch.exp(torch.linspace(-10.0, 0.0, 1 << 20))     # (see phase_parity)
    cfg = replace(get_config(MIXTRAL_ARCH), num_layers=2, dtype="float32")
    budget = (W.base_weight_bytes(cfg) + 2 * W.mixer_weight_bytes(cfg, "attn")
              + W.ffn_module_weight_bytes(cfg, "moe"))
    before = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=1, device=dev)
    cpu_params = _to_cpu(params)
    store = ParamStore(cfg, params, resident_bytes=budget, device=dev)
    del params
    streamed = [li for li in range(2) if store._host[li] is not None]
    B, S = 4, 48
    lengths = np.array([48, 31, 9, 48])
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    plan = Plan(B=B, b_a=B, b_e=B, omega=0.0)
    out = {}
    for where in (dev, "cpu"):
        ops.reset_launch_counts()
        eng = (ModuleBatchingEngine(cfg, None, plan, max_seq=S + 8, store=store, device=dev)
               if where == dev else
               ModuleBatchingEngine(cfg, cpu_params, plan, max_seq=S + 8, device="cpu"))
        t0 = time.perf_counter()
        lg = [eng.prefill(prompts, lengths=lengths).float().cpu()]
        toks = [lg[0].argmax(-1)]
        for t in range(3):
            lg.append(eng.decode_step(toks[-1], lengths + t).float().cpu())
            toks.append(lg[-1].argmax(-1))
        out["cpu" if where == "cpu" else "card"] = (lg, toks, time.perf_counter() - t0,
                                                    ops.launch_counts())
        del eng
    scale = float(out["cpu"][0][0].abs().max())
    errs = [float((a - b).abs().max()) / scale for a, b in zip(out["card"][0], out["cpu"][0])]
    same = all(torch.equal(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))
    launched = {k: out["card"][3][k] for k in PATH_KERNELS["serve_mixtral"]}
    htod = store.take_counters()[0]
    emit({"phase": "serve_mixtral", "what": "parity", "layers": 2, "dtype": "float32",
          "streamed_layers": streamed, "B": B, "S": S, "lengths": lengths.tolist(),
          "rel_err_per_step": errs, "tolerance": 1e-3, "tokens_match": same,
          "card_launches": launched, "card_htod_gb": htod / 1e9,
          "cpu_s": out["cpu"][2], "cuda_s": out["card"][2]})
    del store, out
    torch.cuda.empty_cache()
    freed("serve_mixtral", "parity store", before)
    if streamed != [1]:
        raise AssertionError(f"parity: streamed layers {streamed}, expected [1]")
    if not (max(errs) < 1e-3 and same):
        raise AssertionError(f"Mixtral card vs CPU: errors {errs}, tokens match {same}")
    if not ((dev.type != "cuda" or all(v > 0 for v in launched.values())) and htod > 0):
        raise AssertionError(f"Mixtral card vs CPU: a kernel was never launched "
                             f"({launched}) or nothing streamed ({htod} bytes)")


def phase_serve_mixtral(dev):
    """Full-width, full-depth Mixtral-8x7B (bf16, seeded) built by
    ``ParamStore.seeded`` with 60 GB resident: the stacks of layers 20-31
    (33.8 GB) in page-locked host memory.  64 requests of 128..512 tokens,
    decode 16, B 64, the planner's b_a, b_e = B: whole-stack streaming
    under both schedulers, the streamed tick's profile with K1-K4 captured
    (K1/K2 on weights that came through the window) and held to their plain
    versions once the store is freed, then a store with the planner's
    ``predict_topk`` (4), static, and its tick's profile (the experts
    copied held to the trace's copies).  The three runs give identical
    tokens; whole-stack htod and copied bytes as reckoned; every store and
    server frees its device and page-locked bytes.  Then
    ``mixtral_parity``."""
    import numpy as np

    from repro_torch.core import planner
    from repro_torch.core import workload as W
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.weights import ParamStore

    t_phase = time.perf_counter()
    cfg, plan, lens, decode_len = serve_setup(mixtral_lengths(), MIXTRAL_DECODE, MIXTRAL_ARCH)
    n, max_seq = len(lens), MIXTRAL_MAX + MIXTRAL_DECODE
    rp = W.plan_residency(cfg, MIXTRAL_BUDGET)
    stack = W.ffn_module_weight_bytes(cfg, "moe")
    layers = [i for i, r in enumerate(rp.ffn_resident) if not r]
    kv = n * max_seq * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    # reckoned before the first card run: about 2.5 GB of live activations in
    # one layer of a 32-prompt prefill micro-batch (the (E, C, F) h of K1 at
    # C 4096 is 0.94 GB of it)
    reckoning = {"resident_gb": rp.resident_bytes / 1e9,
                 "base_gb": W.base_weight_bytes(cfg) / 1e9,
                 "mixers_gb": cfg.num_layers * W.mixer_weight_bytes(cfg, "attn") / 1e9,
                 "resident_stacks_gb": (cfg.num_layers - len(layers)) * stack / 1e9,
                 "window_gb": 2 * stack / 1e9, "kv_gb": kv / 1e9,
                 "prefill_activations_gb": 2.5}
    reckoning["device_total_gb"] = (reckoning["resident_gb"] + reckoning["window_gb"]
                                    + reckoning["kv_gb"] + 2.5)
    khat = planner.default_predict_topk(cfg)
    emit({"phase": "serve_mixtral", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "experts": cfg.num_experts, "d_ff": cfg.moe_d_ff,
          "model_gb": W.model_bytes(cfg) / 1e9, "requests": n,
          "prompt_lens": [min(lens), max(lens)], "prompt_tokens": sum(lens),
          "decode_len": decode_len, "max_seq": max_seq,
          "plan": {"B": plan.B, "b_a": plan.b_a, "b_e": plan.b_e, "predict_topk": khat},
          "resident_bytes": MIXTRAL_BUDGET, "streamed_stack_layers": layers,
          "streamed_gb": len(layers) * stack / 1e9, "memory_reckoning": reckoning,
          "host": host_meminfo(), "card_total_gb": (
              torch.cuda.get_device_properties(dev).total_memory / 1e9
              if dev.type == "cuda" else None)})
    requests = synthetic_requests(DatasetSpec("mixtral", n, MIXTRAL_MAX, decode_len),
                                  cfg.vocab_size, seed=0, prompt_lens=lens)
    torch.cuda.reset_peak_memory_stats()
    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()

    def build(k):
        t0 = time.perf_counter()
        store = ParamStore.seeded(cfg, 0, resident_bytes=MIXTRAL_BUDGET, predict_topk=k,
                                  device=dev)
        torch.cuda.synchronize()
        emit({"phase": "serve_mixtral", "store": store.describe(),
              "build_s": time.perf_counter() - t0,
              "resident_module_gb": store.resident_module_bytes() / 1e9,
              "streamed_module_gb": store.streamed_module_bytes() / 1e9,
              "device_buffers_gb": store.device_buffer_bytes() / 1e9,
              "pinned_gb": wmod.pinned_bytes() / 1e9,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9, "host": host_meminfo()})
        return store

    def release(store_name):
        torch.cuda.empty_cache()
        freed("serve_mixtral", store_name, before)
        if wmod.pinned_bytes() != pinned:
            raise AssertionError(f"serve_mixtral: {store_name} left "
                                 f"{wmod.pinned_bytes() - pinned} page-locked bytes")

    store = build(0)
    tokens, counts = {}, {}
    for sched in ("static", "continuous"):
        rec = streamed_run(dev, cfg, None, plan, requests, decode_len, "serve_mixtral",
                           sched, store=store)
        got = [r.tokens for r in rec["report"].request_results]
        check_streamed("serve_mixtral", sched, rec, tokens.get("static", got), decode_len,
                       counts.get("static"))
        tokens[sched], counts[sched] = got, rec["counts"]
    calls, _ = streamed_profile(dev, "serve_mixtral", cfg, None, plan, requests, max_seq, store)
    del store                        # room for the plain versions' f32 copies
    rows = check_path_kernels("serve_mixtral", calls)
    del calls
    release("whole-stack store and the captured calls")
    store = build(khat)
    rec = streamed_run(dev, cfg, None, plan, requests, decode_len, "serve_mixtral", "static",
                       store=store)
    out = check_streamed("serve_mixtral", "static", rec, tokens["static"], decode_len,
                         counts["static"])
    n_pred = sum(store.streams_experts(li) for li in range(cfg.num_layers))
    if rec["planned_reads"] != rec["ticks"] * n_pred:
        raise AssertionError(f"serve_mixtral: {rec['planned_reads']} planned reads, "
                             f"expected {rec['ticks']} ticks x {n_pred} layers")
    streamed_profile(dev, "serve_mixtral", cfg, None, plan, requests, max_seq, store,
                     capture=False)
    del store, rec
    release("predictive store")
    emit({"phase": "serve_mixtral", "runs_identical": True, "predict_topk": khat,
          "predictive_decode_tok_s": out["decode_tok_s"],
          "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "tokens_in_range": bool(np.concatenate(tokens["static"]).max() < cfg.vocab_size)})
    mixtral_parity(dev)
    emit({"phase": "serve_mixtral", "seconds": time.perf_counter() - t_phase})
    return counts["static"], rows


# ---------------------------------------------------------------------------
# Phase 7: card against CPU, f32
# ---------------------------------------------------------------------------
def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def parity_models():
    """(config, its prompts (name, (B, S), lengths), the kernels its card
    run must launch): OLMoE and Mamba2 at full width but 2 layers, and the
    Jamba smoke config (one full interleave period: SSM, attention, MoE and
    dense layers), where K1-K5 all run in one model."""
    import numpy as np

    from repro_torch.configs import get_config

    return (
        (replace(get_config("olmoe-1b-7b"), num_layers=2, dtype="float32"),
         (("short", (4, 32), None), ("long", (2, 1536), np.array([1536, 1100]))),
         ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention")),
        (replace(get_config(SSM_ARCH), num_layers=2, dtype="float32"),
         (("mamba2-600-300", (2, 600), np.array([600, 300])),), ("ssd_scan",)),
        (replace(get_config("jamba-1.5-large-398b", smoke=True), dtype="float32"),
         (("jamba-smoke-100-77", (2, 100), np.array([100, 77])),),
         ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention",
          "ssd_scan")),
    )


def phase_parity(dev):
    """Card (kernels) against CPU (plain versions), f32, for each of
    ``parity_models``: prefill of the prompts (ragged where lengths are
    given) and 3 decode steps.  Logits within 1e-3 of their scale, identical
    greedy tokens, and every kernel of the model launched on the card."""
    import numpy as np

    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    # PyTorch's CPU exp can be less accurate on its first multithreaded call
    # in a process (7e-5 relative, seen on a CPU build of torch 2.13): warm it
    torch.exp(torch.linspace(-10.0, 0.0, 1 << 20))
    rng = np.random.default_rng(1)
    for cfg, cases, kernels in parity_models():
        params = M.init_params(cfg, seed=1, device=dev)
        cpu_params = _to_cpu(params)
        for name, shape, lengths in cases:
            B, S = shape
            prompts = rng.integers(0, cfg.vocab_size, shape)
            pos = np.full(B, S) if lengths is None else lengths
            plan = Plan(B=B, b_a=B, b_e=B, omega=0.0)
            out = {}
            for where, p in ((dev, params), ("cpu", cpu_params)):
                ops.reset_launch_counts()
                eng = ModuleBatchingEngine(cfg, p, plan, max_seq=S + 8, device=where)
                t0 = time.perf_counter()
                lg = [eng.prefill(prompts, lengths=lengths).float().cpu()]
                toks = [lg[0].argmax(-1)]
                for t in range(3):
                    lg.append(eng.decode_step(toks[-1], pos + t).float().cpu())
                    toks.append(lg[-1].argmax(-1))
                key = "cpu" if where == "cpu" else "card"
                out[key] = (lg, toks, time.perf_counter() - t0, ops.launch_counts())
                del eng
            scale = float(out["cpu"][0][0].abs().max())
            errs = [float((a - b).abs().max()) / scale
                    for a, b in zip(out["card"][0], out["cpu"][0])]
            same = all(torch.equal(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))
            launched = {k: out["card"][3][k] for k in kernels}
            emit({"phase": "parity", "arch": cfg.name, "layers": cfg.num_layers,
                  "case": name, "B": B, "S": S,
                  "lengths": None if lengths is None else lengths.tolist(),
                  "rel_err_per_step": errs, "tolerance": 1e-3, "tokens_match": same,
                  "card_launches": launched, "cpu_launches": sum(out["cpu"][3].values()),
                  "cpu_s": out["cpu"][2], "cuda_s": out["card"][2]})
            if not (max(errs) < 1e-3 and same):
                raise AssertionError(f"card vs CPU ({cfg.name}, {name}): errors {errs}, "
                                     f"tokens match {same}")
            if dev.type == "cuda" and not all(v > 0 for v in launched.values()):
                raise AssertionError(f"card vs CPU ({cfg.name}, {name}): a kernel was "
                                     f"never launched on the card: {launched}")
        del params, cpu_params
        torch.cuda.empty_cache()
    parity_omega_paged(dev, rng)
    parity_prefix_hit(dev, rng)
    parity_frontend(dev, rng)


def parity_frontend(dev, rng):
    """musicgen-medium at full width but 2 layers, f32: 2 prompts whose first
    ``frontend_tokens`` (256) positions are the audio frontend stub's frame
    embeddings, then 44 tokens; the engine's prefill (K4) and 3 decode steps
    (K3), card against CPU: logits within 1e-3 of their scale, the same
    greedy tokens, K4 and K3 launched."""
    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.frontends import frontend_embeddings

    cfg = replace(get_config("musicgen-medium"), num_layers=2, dtype="float32")
    B, S = 2, cfg.frontend_tokens + 44
    params = M.init_params(cfg, seed=1, device=dev)
    cpu_params = _to_cpu(params)
    fe = frontend_embeddings(cfg, B, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, (B, S))
    plan = Plan(B=B, b_a=B, b_e=B, omega=0.0)
    out = {}
    for where, p in ((dev, params), ("cpu", cpu_params)):
        ops.reset_launch_counts()
        eng = ModuleBatchingEngine(cfg, p, plan, max_seq=S + 8, device=where)
        lg = [eng.prefill(prompts, fe).float().cpu()]
        toks = [lg[0].argmax(-1)]
        for t in range(3):
            lg.append(eng.decode_step(toks[-1], S + t).float().cpu())
            toks.append(lg[-1].argmax(-1))
        out["cpu" if where == "cpu" else "card"] = (lg, toks, ops.launch_counts())
        del eng
    scale = float(out["cpu"][0][0].abs().max())
    errs = [float((a - b).abs().max()) / scale for a, b in zip(out["card"][0], out["cpu"][0])]
    same = all(torch.equal(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))
    launched = {k: out["card"][2][k] for k in ("flash_attention", "decode_attention")}
    emit({"phase": "parity", "arch": cfg.name, "layers": 2, "case": "frontend",
          "B": B, "S": S, "frontend_tokens": cfg.frontend_tokens,
          "rel_err_per_step": errs, "tolerance": 1e-3, "tokens_match": same,
          "card_launches": launched})
    if not (max(errs) < 1e-3 and same):
        raise AssertionError(f"card vs CPU (musicgen frontend): errors {errs}, tokens "
                             f"match {same}")
    if dev.type == "cuda" and not all(v > 0 for v in launched.values()):
        raise AssertionError(f"card vs CPU (musicgen frontend): K4 or K3 never launched: "
                             f"{launched}")
    del params, cpu_params
    torch.cuda.empty_cache()


def parity_prefix_hit(dev, rng):
    """OLMoE at full width but 2 layers, f32, 128-token pages: prefill a
    prompt into row 0, capture its 640-token prefix, admit a second prompt
    with the same prefix (and its own 77 tokens) into row 1 as a hit.  The
    card (K4 with q_offset 640, one launch a layer) against the CPU (plain
    versions): the hit's logits within 1e-3 of the scale, the same greedy
    token; the card's hit also against the card's cold prefill of the
    second prompt."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.cache import CacheConfig

    cfg = replace(get_config("olmoe-1b-7b"), num_layers=2, dtype="float32")
    pspan = 5 * PAGE_TOKENS
    head = rng.integers(0, cfg.vocab_size, pspan)
    pa = np.concatenate([head, rng.integers(0, cfg.vocab_size, 40)])
    pb = np.concatenate([head, rng.integers(0, cfg.vocab_size, 77)])
    plan = Plan(B=2, b_a=2, b_e=2, omega=0.0)
    cc = CacheConfig(page_tokens=PAGE_TOKENS, prefix_cache=True)
    before = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=1, device=dev)
    out = {}
    for where, p in ((dev, params), ("cpu", _to_cpu(params))):
        eng = ModuleBatchingEngine(cfg, p, plan, max_seq=len(pb) + 8, device=where,
                                   cache_config=cc)
        eng.init_cache(2)
        eng.prefill_slots(pa[None], [0])
        kvs = eng.read_prefix_rows(0, pspan)
        ops.reset_launch_counts()
        lg = eng.prefill_prefix_hit(1, pb, kvs, pspan).float().cpu()
        k4 = ops.launch_counts()["flash_attention"]
        cold = eng.prefill_slots(pb[None], [1]).float().cpu()
        out["cpu" if where == "cpu" else "card"] = (lg, cold, k4, eng.stats.planned_reads)
        del eng, kvs, p
    del params
    scale = float(out["cpu"][0].abs().max())
    err = float((out["card"][0] - out["cpu"][0]).abs().max()) / scale
    vs_cold = float((out["card"][0] - out["card"][1]).abs().max()) / scale
    same = bool(torch.equal(out["card"][0].argmax(-1), out["cpu"][0].argmax(-1)))
    emit({"phase": "parity", "arch": cfg.name, "layers": 2, "case": "prefix-hit",
          "prefix": pspan, "suffix": len(pb) - pspan, "hit_rel_err": err,
          "hit_vs_card_cold_prefill_rel_err": vs_cold, "tolerance": 1e-3, "tokens_match": same,
          "card_k4_launches_in_hit": out["card"][2], "planned_reads": out["card"][3]})
    if not (err < 1e-3 and vs_cold < 1e-3 and same):
        raise AssertionError(f"card vs CPU (prefix hit): {err}, against the cold prefill "
                             f"{vs_cold}, tokens match {same}")
    if dev.type == "cuda" and not (out["card"][2] == cfg.num_layers and out["card"][3] == 1):
        raise AssertionError(f"card vs CPU (prefix hit): K4 launched {out['card'][2]} times "
                             f"in the hit, {out['card'][3]} planned reads")
    torch.cuda.empty_cache()
    freed("parity", "prefix-hit engine", before)


def parity_omega_paged(dev, rng):
    """OLMoE at full width but 2 layers, f32, omega 0.5 and Mode B with a
    1-byte device budget (every frame in page-locked host memory, streamed
    through the window): the card (host rows on the CPU, K3p on the device
    rows) against the CPU (plain versions), prefill and 3 decode steps of a
    ragged batch: identical greedy tokens, K3p launched on the card, every
    logit within 1e-3 of the scale.

    The host mechanism rounds its operands to bf16 (the paper's §B), so
    inputs a few f32 ulps apart (the card's projections against the CPU's)
    would flip some roundings.  So the mechanism's inputs (q and the
    assembled K/V span, slot written) are held apart from its output: each
    call's inputs on the card within 1e-3 of the CPU run's own, which a
    wrong slot, row split or stale page would miss by the scale of the
    values; then the CPU run's mechanism takes the card's inputs of the same
    call, so that the host rows' logits differ only where the engines do.
    Each layer's host frames cross once a tick, the first on demand."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.cache import CacheConfig

    cfg = replace(get_config("olmoe-1b-7b"), num_layers=2, dtype="float32")
    B, S, steps = 4, 48, 3
    prompts = rng.integers(0, cfg.vocab_size, (B, S))
    lengths = np.array([48, 30, 41, 17])
    plan = Plan(B=B, b_a=B, b_e=B, omega=0.5)
    cc = CacheConfig(page_tokens=16, device_pool_bytes=1.0)
    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    params = M.init_params(cfg, seed=1, device=dev)
    out, inputs = {}, {}

    def tap(eng, feed):
        """Record each host-mechanism call's inputs; with ``feed``, run the
        mechanism on the inputs ``feed`` recorded for the same call."""
        attend, seen = eng._host_attend, []

        def host_attend(p, q, kc, vc, pos_np, heads=False):
            seen.append((q.clone(), kc.clone(), vc.clone()))
            if feed is not None:
                q, kc, vc = feed[len(seen) - 1]
            return attend(p, q, kc, vc, pos_np, heads)

        eng._host_attend = host_attend
        return seen

    for where, p in ((dev, params), ("cpu", _to_cpu(params))):
        key = "cpu" if where == "cpu" else "card"
        ops.reset_launch_counts()
        eng = ModuleBatchingEngine(cfg, p, plan, max_seq=S + 8, device=where, cache_config=cc)
        inputs[key] = tap(eng, inputs.get("card"))
        lg = [eng.prefill(prompts, lengths=lengths).float().cpu()]
        toks = [lg[0].argmax(-1)]
        for t in range(steps):
            lg.append(eng.decode_step(toks[-1], lengths + t).float().cpu())
            toks.append(lg[-1].argmax(-1))
        eng.sync_stats()
        out[key] = (lg, toks, ops.launch_counts(), eng.stats.host_attn_tokens,
                    eng.stats.kv_htod_bytes, eng.pages.demand_fetches,
                    eng.pages.host_pool_bytes() // eng._n_attn)
        del eng._host_attend                # the tap holds the engine: break the cycle
        del eng, p
    del params
    scale = float(out["cpu"][0][0].abs().max())
    n_host = int(round(plan.omega * B))

    def err(rows):
        return [float((a[rows] - b[rows]).abs().max()) / scale
                for a, b in zip(out["card"][0][1:], out["cpu"][0][1:])]

    pre = float((out["card"][0][0] - out["cpu"][0][0]).abs().max()) / scale
    dev_err, host_err = err(slice(n_host, B)), err(slice(0, n_host))
    in_err = [max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(card, cpu))
              for card, cpu in zip(inputs["card"], inputs["cpu"])]
    same = all(torch.equal(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))
    k3p = out["card"][2]["decode_attention_paged"]
    htod, demand, layer_bytes = out["card"][4:7]
    htod_want = (cfg.num_layers * steps + 1) * layer_bytes
    emit({"phase": "parity", "arch": cfg.name, "layers": 2, "case": "omega-0.5-mode-B",
          "B": B, "S": S, "lengths": lengths.tolist(), "host_rows": n_host,
          "prefill_rel_err": pre, "device_rows_rel_err_per_step": dev_err,
          "host_rows_rel_err_per_step": host_err,
          "host_mechanism_calls": [len(inputs["card"]), len(inputs["cpu"])],
          "host_mechanism_inputs_rel_err_per_call": in_err, "tolerance": 1e-3,
          "tokens_match": same, "card_k3p_launches": k3p,
          "host_attn_tokens": [out["card"][3], out["cpu"][3]],
          "kv_htod_bytes": [htod, out["cpu"][4]], "kv_htod_reckoned": htod_want,
          "kv_demand_fetches": [demand, out["cpu"][5]]})
    calls = cfg.num_layers * steps
    if not (max([pre] + dev_err + host_err + in_err) < 1e-3 and same
            and len(inputs["card"]) == len(inputs["cpu"]) == calls
            and out["card"][3] == out["cpu"][3] > 0):
        raise AssertionError(f"card vs CPU (omega 0.5, Mode B): prefill {pre}, device rows "
                             f"{dev_err}, host rows {host_err}, host mechanism inputs "
                             f"{in_err} ({len(inputs['card'])} calls of {calls}), "
                             f"tokens match {same}")
    if dev.type == "cuda" and not (k3p > 0 and htod == out["cpu"][4] == htod_want
                                   and demand == out["cpu"][5] == 1):
        raise AssertionError(f"card vs CPU (omega 0.5, Mode B): K3p launched {k3p} times, "
                             f"KV bytes {htod} and {out['cpu'][4]} (reckoned {htod_want}), "
                             f"demand fetches {demand} and {out['cpu'][5]} (1 expected)")
    torch.cuda.empty_cache()
    freed("parity", "omega + Mode B engine", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError("parity: the omega + Mode B engine left page-locked bytes")

# ---------------------------------------------------------------------------
# Distributed serving: replicas in one process, expert-parallel rank processes
# ---------------------------------------------------------------------------
REPLICAS, EP_RANKS, SHARDED_RANKS = 2, 2, 2
FAILOVER = "seed=1,kill=1@3"      # replica 1 dies at fleet step 3
EP_NOTE = ("two rank processes sharing one card, exchanging through host memory by gloo: "
           "one card's figures, not an interconnect's")


def serve_requests(cfg, lens, decode_len: int):
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests

    return synthetic_requests(DatasetSpec("smoke", len(lens), max(lens), decode_len),
                              cfg.vocab_size, seed=0, prompt_lens=lens)


def logit_gate(phase: str, what: str, got: dict, want: dict, keys) -> dict:
    """Each request's first-token logits ``got[i]`` within 0.02 of the peak of
    ``want[i]`` (the one-Server run's row); returns the worst and median."""
    import numpy as np

    errs = []
    for i in keys:
        w = want[i].float()
        errs.append(float((got[i].float() - w).abs().max() / w.abs().max()))
    rec = {"phase": phase, "logits": what, "rel_err_max": max(errs),
           "rel_err_median": float(np.median(errs)),
           "bit_identical_rows": sum(int(torch.equal(got[i], want[i])) for i in keys),
           "rows": len(errs)}
    emit(rec)
    if rec["rel_err_max"] >= REL_BF16:
        raise AssertionError(f"{phase} {what}: first-token logits {rec['rel_err_max']} of "
                             f"the row peak off the one-Server run's (gate {REL_BF16})")
    return rec


def fleet_run(dev, cfg, params, plan, requests, serve_kw: dict, policy: str) -> dict:
    """``requests`` through a ``ReplicaServer`` of ``REPLICAS`` replicas on the
    card (the weight tensors shared), the launch counts set to 0 just before
    and read just after; each replica's first-token logits, decode-chunk
    host syncs, requests in local order and waves are kept.  The deleted
    fleet must free every engine."""
    from repro_torch.distributed import ReplicaServer
    from repro_torch.kernels import ops
    from repro_torch.serving import weights as wmod
    from repro_torch.serving.server import ServeConfig

    before, pinned = torch.cuda.memory_allocated(), wmod.pinned_bytes()
    rs = ReplicaServer(cfg, params, REPLICAS, plan=plan, serve=ServeConfig(**serve_kw),
                       policy=policy, device=dev)
    for r in requests:
        rs.submit(r)
    logits, syncs = [], []
    for s in rs.servers:
        s._ensure_engine()
        logits.append(first_logits(s))
        syncs.append(watch_decode_syncs(s))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rs.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"merged": rep.merged, "per_replica": rep.per_replica, "wall_s": wall,
           "counts": ops.launch_counts(), "routes": list(rs._routes),
           "syncs": [dict(x) for x in syncs],
           "requests": [[h.request for h in s._handles] for s in rs.servers],
           "fused": [s._engine.stats.fused_ticks for s in rs.servers],
           "B": [s._b for s in rs.servers],
           "logits": {g: logits[i][local] for g, (i, local) in enumerate(rs._routes)}}
    for s in rs.servers:
        untap(s._engine)
        untap(s)
    del rs, s
    freed("serve_replicas", f"{policy} fleet of {REPLICAS} replicas", before)
    if wmod.pinned_bytes() != pinned:
        raise AssertionError("serve_replicas: the deleted fleet left page-locked bytes")
    return rec


def check_fleet(run: str, rec: dict, n_requests: int, decode_len: int) -> None:
    """Every request served once, in submission order, with its tokens;
    merged work counters the replicas' sums and phase times their maxima;
    no host wait in a decode chunk but the planned ones."""
    m, per = rec["merged"], rec["per_replica"]
    if [r.index for r in m.request_results] != list(range(n_requests)) or any(
            r.tokens.size != decode_len for r in m.request_results):
        raise AssertionError(f"serve_replicas {run}: requests not served once each in "
                             f"submission order")
    for name in ("decode_slot_steps", "wasted_slot_steps", "prefill_tokens", "a2a_bytes",
                 "collective_dispatches", "expert_tokens_dropped"):
        if getattr(m, name) != sum(getattr(r, name) for r in per):
            raise AssertionError(f"serve_replicas {run}: merged {name} is not the sum")
    if m.decode_s != max(r.decode_s for r in per) or m.prefill_s != max(
            r.prefill_s for r in per):
        raise AssertionError(f"serve_replicas {run}: merged phase times are not the maxima")
    if any(rec["syncs"]):
        raise AssertionError(f"serve_replicas {run}: host syncs inside decode chunks: "
                             f"{rec['syncs']}")
    if m.expert_tokens_dropped:
        raise AssertionError(f"serve_replicas {run}: {m.expert_tokens_dropped} copies dropped")


def phase_serve_replicas(dev, params):
    """Serve's 64 requests on ``REPLICAS`` data-parallel replicas behind one
    queue, in this process, the weights shared: static under
    ``least-loaded`` then ``round-robin`` routing, then continuous with one
    decode tick a step and replica 1 killed at fleet step 3 (``FAILOVER``).
    Each replica is held bit for bit to a witness: a fault-free ``Server``
    fed exactly that replica's requests in its order and waves, at its
    batch; the merged first-token logits within 0.02 of the one-Server
    run's row peak; the failover run fails over once, requeues the dead
    replica's requests and gives its witness's tokens.  Returns the static
    least-loaded run's launch counts."""
    import numpy as np

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    requests = serve_requests(cfg, lens, decode_len)
    n = len(requests)
    base = dict(decode_len=decode_len, max_seq=max(lens) + decode_len)
    one = served(dev, cfg, params, plan, requests, dict(base, scheduler="static"),
                 phase="serve_replicas", taps=first_logits)
    one_logits = one["seen"]
    runs, witnessed = {}, {}
    for policy in ("least-loaded", "round-robin"):
        rec = fleet_run(dev, cfg, params, plan, requests, dict(base, scheduler="static"),
                        policy)
        check_fleet(policy, rec, n, decode_len)
        counts = rec["counts"]
        ticks = [r.decode_slot_steps // b for r, b in zip(rec["per_replica"], rec["B"])]
        if any(f != t for f, t in zip(rec["fused"], ticks)):
            raise AssertionError(f"serve_replicas {policy}: decode ticks {ticks}, graph "
                                 f"replays {rec['fused']}")
        if dev.type == "cuda" and (not all(counts[k] > 0 for k in PATH_KERNELS["serve_replicas"])
                                   or any(counts[k] != counts[f"{k}_{d}"] for k, d in NEW_DESIGNS)):
            raise AssertionError(f"serve_replicas {policy}: launches {counts}")
        key = tuple(rec["routes"])
        if key not in witnessed:            # both policies route serve's requests alike
            witnessed[key] = [
                wave_witness(dev, cfg, params, plan, reqs, dict(base, scheduler="static"),
                             [list(w) for w in r.admission_waves], phase="serve_replicas",
                             max_batch=b)
                for reqs, r, b in zip(rec["requests"], rec["per_replica"], rec["B"])]
        for i, (w, r) in enumerate(zip(witnessed[key], rec["per_replica"])):
            got = [x.tokens for x in sorted(r.request_results, key=lambda x: x.index)]
            if not all(np.array_equal(a, b) for a, b in zip(got, w["tokens"])):
                raise AssertionError(f"serve_replicas {policy}: replica {i} differs from "
                                     f"its witness")
        same = [bool(np.array_equal(a.tokens, b))
                for a, b in zip(rec["merged"].request_results, one["tokens"])]
        gate = logit_gate("serve_replicas", policy, rec["logits"], one_logits, range(n))
        m = rec["merged"]
        emit({"phase": "serve_replicas", "run": policy, "replicas": REPLICAS,
              "wall_s": rec["wall_s"], "decode_tok_s": m.decode_throughput,
              "prefill_tok_s": m.prefill_throughput,
              "per_replica": [{"requests": len(r.request_results), "B": b,
                               "decode_tok_s": r.decode_throughput,
                               "decode_s": r.decode_s, "prefill_s": r.prefill_s,
                               "waves": r.admission_waves}
                              for r, b in zip(rec["per_replica"], rec["B"])],
              "witness_bit_identical": True, "requests_equal_to_one_server": sum(same),
              "logits_rel_err_max": gate["rel_err_max"], "launches": counts})
        runs[policy] = rec
    # failover: continuous, one decode tick a step, replica 1 killed
    kw = dict(base, scheduler="continuous", decode_chunk=1)
    rec = fleet_run(dev, cfg, params, plan, requests, dict(kw, faults=FAILOVER),
                    "round-robin")
    check_fleet("failover", rec, n, decode_len)
    m = rec["merged"]
    if m.failovers != 1 or m.requeued_requests <= 0:
        raise AssertionError(f"serve_replicas failover: {m.failovers} failovers, "
                             f"{m.requeued_requests} requeued")
    survivor = 0
    reqs, r = rec["requests"][survivor], rec["per_replica"][survivor]
    w = wave_witness(dev, cfg, params, plan, reqs, kw, [list(x) for x in r.admission_waves],
                     phase="serve_replicas", max_batch=rec["B"][survivor])
    got = {x.index: x.tokens for x in r.request_results}
    if not all(np.array_equal(got[i], t) for i, t in enumerate(w["tokens"]) if i in got):
        raise AssertionError("serve_replicas failover: the survivor differs from its witness")
    served_by = {i for i, _ in rec["routes"]}
    same = [bool(np.array_equal(a.tokens, b)) for a, b in zip(m.request_results,
                                                               one["tokens"])]
    gate = logit_gate("serve_replicas", "failover", rec["logits"], one_logits, range(n))
    emit({"phase": "serve_replicas", "run": "failover", "faults": FAILOVER,
          "failovers": m.failovers, "requeued_requests": m.requeued_requests,
          "served_by": sorted(served_by), "survivor_waves": r.admission_waves,
          "wall_s": rec["wall_s"], "decode_tok_s": m.decode_throughput,
          "witness_bit_identical": True, "requests_equal_to_one_server": sum(same),
          "logits_rel_err_max": gate["rel_err_max"]})
    return runs["least-loaded"]["counts"]


def ep_rank(rank: int, n: int, group, cfg, plan, lens, decode_len: int, device: str):
    """One expert-parallel rank of ``serve_ep``, in its own process on the card:
    seeded OLMoE weights (every expert; this rank owns experts [32 r, 32 r +
    32)), then serve's requests through a ``Server`` whose MoE decode stage
    is collective over ``group``: a2a static (the timed run: launch counts,
    decode-chunk host syncs, the collectives' and the stage's host wall,
    the first decode tick's K1/K2 input on rank 0), a2a continuous, a2a at
    two pipeline chunks, the same serial under the strict sanitizer (its
    planned reads by tag), and psum.  Each deleted server must free its
    bytes.  Returns the runs' records.  (On the CPU, for a rehearsal: no
    syncs to watch, no device bytes to count.)"""
    import numpy as np

    from repro_torch import analysis
    from repro_torch.core import engine as engine_mod
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import expert_gemm, ops
    from repro_torch.models import model as M
    from repro_torch.serving.server import ServeConfig, Server
    from repro_torch.sharding.specs import ShardCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = dev.type == "cuda"
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))   # the host's cores, shared
    sync = torch.cuda.synchronize if card else (lambda: None)
    allocated = torch.cuda.memory_allocated if card else (lambda: 0)
    if card:
        prime(dev)
    params = M.init_params(cfg, seed=0, device=dev)
    requests = serve_requests(cfg, lens, decode_len)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    runs = {}
    for name, disp, chunks, sched, serial in (
            ("a2a", "a2a", 1, "static", False), ("a2a_continuous", "a2a", 1, "continuous", False),
            ("a2a_2", "a2a", 2, "static", False), ("a2a_2_serial", "a2a", 2, "static", True),
            ("psum", "psum", 1, "static", False)):
        before = allocated()
        server = Server(cfg, params, plan, device=dev, serve=ServeConfig(
            scheduler=sched, decode_len=decode_len, max_seq=max(lens) + decode_len,
            sctx=ShardCtx(group=group, moe_dispatch=disp), ep_chunks=chunks))
        for r in requests:
            server.submit(r)
        server._ensure_engine()
        eng = server._engine
        eng.ep_serial = serial
        syncs = watch_decode_syncs(server) if card else {}
        prefill_logits = first_logits(server)
        first, wall = {}, {"collectives": 0.0, "stage": 0.0, "staging": 0.0}
        decode_rows, stage = eng._decode_rows, engine_mod.ep_expert_stage
        post, gather, reduce_ = C._post_all_to_all, C._all_gather, C._all_reduce
        stage_ = C._stage
        ffn = ops.grouped_expert_ffn

        def timed(fn, key):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    wall[key] += time.perf_counter() - t0
            return call

        class Work:
            def __init__(self, work):
                self.work = work

            def wait(self):
                return timed(self.work.wait, "collectives")()

        def posted(*a, **kw):
            recv, work = timed(post, "collectives")(*a, **kw)
            return recv, Work(work)

        def tap_rows(*a, **kw):
            lg = decode_rows(*a, **kw)
            if "logits" not in first:
                first["logits"] = lg.clone()
            return lg

        def tap_ffn(x, *ws):
            if x.shape[0] == E // n and "ffn" not in first:
                first["ffn"] = (x.clone(), ws[-1].clone() if len(ws) == 4 else None)
            return ffn(x, *ws)

        def tap_stage(*a, **kw):
            out = timed(stage, "stage")(*a, **kw)
            if "stage" not in first:
                first["stage"] = out[0].clone()
            return out

        eng._decode_rows = tap_rows
        engine_mod.ep_expert_stage = tap_stage
        C._post_all_to_all, C._all_gather = posted, timed(gather, "collectives")
        C._all_reduce, C._stage = timed(reduce_, "collectives"), timed(stage_, "staging")
        ops.grouped_expert_ffn = tap_ffn
        san = analysis.sanitize(strict=True) if serial else contextlib.nullcontext()
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with san as sanitizer:
                rep = server.run()
            sync()
        finally:
            engine_mod.ep_expert_stage = stage
            C._post_all_to_all, C._all_gather = post, gather
            C._all_reduce, C._stage = reduce_, stage_
            ops.grouped_expert_ffn = ffn
        # the collectives stage their buffers: the staging reads (each a
        # wait for the device) are the stage's, not the exchanges'
        wall["collectives"] -= wall["staging"]
        ticks = rep.decode_slot_steps // server._b
        st = eng.stats
        runs[name] = {
            "wall_s": time.perf_counter() - t0, "counts": ops.launch_counts(),
            "tokens": [r.tokens for r in rep.request_results], "ticks": ticks,
            "decode_tok_s": rep.decode_throughput, "decode_s": rep.decode_s,
            "prefill_s": rep.prefill_s, "server_ms_per_tick": rep.decode_s * 1e3 / ticks,
            "collectives_ms_per_tick": wall["collectives"] * 1e3 / ticks,
            "stage_ms_per_tick": wall["stage"] * 1e3 / ticks,
            "a2a_bytes": rep.a2a_bytes, "a2a_gb": rep.a2a_gb,
            "collective_dispatches": rep.collective_dispatches,
            "clock_broadcasts": rep.clock_broadcasts, "planned_reads": st.planned_reads,
            "fused_ticks": st.fused_ticks, "dropped": rep.expert_tokens_dropped,
            "syncs": dict(syncs), "B": server._b,
            "planned": None if not serial else sanitizer.report()["planned_transfers"],
            "host_reads": None if not serial else sanitizer.report()["host_reads"],
            "first_decode_logits": first["logits"].float().cpu(),
            "first_stage": first["stage"].float().cpu(),
            "first_token_logits": torch.stack([prefill_logits[i]
                                               for i in range(len(requests))]),
            "ffn_input": (None if rank or name != "a2a" else
                          tuple(None if t is None else t.cpu() for t in first["ffn"]))}
        untap(server)
        untap(eng)
        del server, eng, rep, st, first, decode_rows, tap_rows, prefill_logits
        if allocated() != before:
            raise AssertionError(f"serve_ep rank {rank} {name}: the deleted server left "
                                 f"{allocated() - before} bytes")
    # the psum run against the a2a run (the single-device stage bit for bit):
    # the first stage's rows (layer 0, first decode tick, the same inputs),
    # the first-token logits and the first decode tick's logits, each over
    # its row's peak
    rel = {}
    for key in ("first_stage", "first_token_logits", "first_decode_logits"):
        a, p = runs["a2a"][key], runs["psum"][key]
        rel[key] = float(((p - a).abs().amax(-1) / a.abs().amax(-1).clamp_min(1e-30)).max())
        for r in runs.values():
            del r[key]
    cap_l = min(min(plan.b_e, plan.B), plan.B * cfg.experts_per_token)
    return {"runs": runs, "psum_rel_err": rel,
            "designs": {"expert_gate_up": expert_gemm.expert_gate_up_design(
                            torch.bfloat16, E // n, D, F, cap_l),
                        "grouped_matmul": expert_gemm.grouped_matmul_design(
                            torch.bfloat16, E // n, F, D)},
            "local_shape": {"E": E // n, "C": cap_l, "D": D, "F": F}}


def phase_serve_ep(dev, params, oracle=None):
    """Serve's 64 requests on ``EP_RANKS`` expert-parallel rank processes
    sharing the card over a gloo group, each rank holding every weight and
    owning 32 of the 64 experts (``ep_rank``).  A rank that fails fails the
    phase.  Gates: every a2a run's tokens equal the single-process
    per-module oracle's bit for bit (``oracle``: serve's static tokens,
    which equal the oracle's; computed here when absent) on every rank,
    serial equal to pipelined; psum's stage rows (layer 0, the first decode
    tick) and first-token logits within 0.02 of the a2a run's row peak
    (its first decode tick's logits and its tokens equal to the oracle's
    are printed); a2a bytes the per-stage bytes times the stages, one
    stage per MoE layer and decode tick; K1 and K2 launched on every rank,
    every launch the wgmma design; no host wait in a decode chunk outside
    the planned ``ep-*`` scopes, and those counted by tag; nothing dropped.
    Then K1 and K2 are held to their plain versions, timed, on rank 0's
    first decode stage input (E/n experts).  Returns (rank 0's a2a launch
    counts, the K1/K2 rows)."""
    import numpy as np

    from repro_torch.distributed import ep_engine
    from repro_torch.launch import mesh

    cfg, plan, lens, decode_len = serve_setup(short_lengths(), 32)
    requests = serve_requests(cfg, lens, decode_len)
    if oracle is None:
        oracle = list(per_module_oracle(dev, cfg, params, plan, requests, decode_len,
                                        "serve_ep")[0])
    # the ranks are other processes: the blocks this one's allocator keeps
    # cached from the earlier phases go back to the card first
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = mesh.spawn(ep_rank, EP_RANKS, (cfg, plan, lens, decode_len, dev.type),
                      timeout_s=600.0, group_timeout_s=120.0)
    wall = time.perf_counter() - t0
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe")
    for name, run in outs[0]["runs"].items():
        emit({"phase": "serve_ep", "run": name, "ranks": EP_RANKS, "card": gpu_line(),
              "note": EP_NOTE, "decode_tok_s": run["decode_tok_s"],
              "decode_tok_s_by_rank": [o["runs"][name]["decode_tok_s"] for o in outs],
              "server_ms_per_tick": run["server_ms_per_tick"],
              "collectives_host_ms_per_tick": run["collectives_ms_per_tick"],
              "stage_host_ms_per_tick": run["stage_ms_per_tick"],
              "a2a_gb": run["a2a_gb"], "collective_dispatches": run["collective_dispatches"],
              "planned_reads": run["planned_reads"], "clock_broadcasts": run["clock_broadcasts"],
              "ticks": run["ticks"], "wall_s": run["wall_s"], "prefill_s": run["prefill_s"],
              "planned_by_tag": run["planned"], "syncs": run["syncs"],
              "requests_equal_to_oracle": sum(int(np.array_equal(a, b))
                                              for a, b in zip(run["tokens"], oracle)),
              "launches": run["counts"]})
    emit({"phase": "serve_ep", "spawn_wall_s": wall, "designs": outs[0]["designs"],
          "local_shape": outs[0]["local_shape"],
          "psum_rel_err": [o["psum_rel_err"] for o in outs]})
    for rank, out in enumerate(outs):
        for name, run in out["runs"].items():
            where = f"serve_ep rank {rank} {name}"
            if name != "psum" and not all(np.array_equal(a, b)
                                          for a, b in zip(run["tokens"], oracle)):
                bad = [i for i, (a, b) in enumerate(zip(run["tokens"], oracle))
                       if not np.array_equal(a, b)]
                raise AssertionError(f"{where}: tokens differ from the per-module oracle "
                                     f"for requests {bad}")
            if run["collective_dispatches"] != n_moe * run["ticks"] or run["fused_ticks"]:
                raise AssertionError(f"{where}: {run['collective_dispatches']} collective "
                                     f"stages for {run['ticks']} per-module ticks")
            per_stage = (ep_engine.a2a_bytes_per_stage(cfg, run["B"], EP_RANKS, 2)
                         if name != "psum" else 0)
            if run["a2a_bytes"] != per_stage * run["collective_dispatches"]:
                raise AssertionError(f"{where}: a2a bytes {run['a2a_bytes']}")
            c = run["counts"]
            if dev.type == "cuda" and (not all(c[k] > 0 for k in PATH_KERNELS["serve_ep"])
                                       or any(c[k] != c[f"{k}_{d}"] for k, d in NEW_DESIGNS)):
                raise AssertionError(f"{where}: launches {c}")
            if run["syncs"] or run["dropped"]:
                raise AssertionError(f"{where}: host syncs {run['syncs']}, dropped "
                                     f"{run['dropped']}")
        a2 = out["runs"]["a2a_2"]
        if not all(np.array_equal(a, b) for a, b in zip(a2["tokens"],
                                                         out["runs"]["a2a_2_serial"]["tokens"])):
            raise AssertionError(f"serve_ep rank {rank}: serial and pipelined differ")
        planned, stages = out["runs"]["a2a_2_serial"]["planned"], a2["collective_dispatches"]
        if (planned.get("ep-a2a-batch") != 2 * stages
                or planned.get("ep-a2a-combine") != 3 * stages
                or out["runs"]["a2a_2_serial"]["host_reads"]):
            raise AssertionError(f"serve_ep rank {rank}: planned reads {planned}")
        # psum reassociates each token's sum over its k copies (allclose, not
        # bitwise, as in the reference): its stage rows and first-token
        # logits are gated; the first decode tick's logits, 16 such stages
        # deep, are printed
        err = out["psum_rel_err"]
        if err["first_stage"] >= REL_BF16 or err["first_token_logits"] >= REL_BF16:
            raise AssertionError(f"serve_ep rank {rank}: psum off the a2a run's: {err} of "
                                 f"the row peak")
        if set(out["designs"].values()) != {"wgmma"}:
            raise AssertionError(f"serve_ep rank {rank}: designs {out['designs']}")
    x, counts = outs[0]["runs"]["a2a"]["ffn_input"]
    moe = params["layers"][0]["moe"]
    lo, hi = 0, cfg.num_experts // EP_RANKS
    rows = check_path_kernels("serve_ep", {("decode-local", "grouped_expert_ffn"): (
        (x.to(dev), moe["experts_w_gate"][lo:hi], moe["experts_w_up"][lo:hi],
         moe["experts_w_down"][lo:hi], None if counts is None else counts.to(dev)), {})})
    return outs[0]["runs"]["a2a"]["counts"], rows


def row_errors(got, want) -> list:
    """Each row's largest error over that row's largest |reference| value
    (small (n, V) logits)."""
    g, w = got.float().cpu(), want.float().cpu()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).tolist()


@contextlib.contextmanager
def routes_recorded(sink):
    """While active, every ``models.moe.route`` call (the engine's decode
    stages, the grouped prefill's and the dense combine's) hands its (T, k)
    expert ids to ``sink``."""
    from repro_torch.models import moe as moe_mod

    route = moe_mod.route

    def tapped(cfg, w, x):
        out = route(cfg, w, x)
        sink(out[1])
        return out

    moe_mod.route = tapped
    try:
        yield
    finally:
        moe_mod.route = route


def first_tick_tap(holder: torch.Tensor, routes: torch.Tensor):
    """A ``served`` tap for the engine's first per-module decode tick: its
    logits go into ``holder`` and each MoE layer's expert ids into
    ``routes[layer]`` (both allocated before the server, so the freed check
    stays exact; device copies, no host read); the engine's stats are kept
    for after the run."""
    def taps(server):
        eng, state = server._engine, {"ticks": 0}
        rows = eng._decode_rows

        def call(*a, **kw):
            if state["ticks"]:
                lg = rows(*a, **kw)
            else:
                layer = iter(range(routes.shape[0]))
                with routes_recorded(lambda idx: routes[next(layer)].copy_(idx)):
                    lg = rows(*a, **kw)
                holder.copy_(lg)
            state["ticks"] += 1
            return lg

        eng._decode_rows = call
        state["stats"] = eng.stats
        return state
    return taps


def same_routing(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Two runs' (layers, rows, k) expert ids: per row, whether they name the
    same experts in every layer; and how many (layer, row) pairs differ."""
    a, b = a.sort(-1).values.cpu(), b.sort(-1).values.cpu()
    alike = (a == b).all(-1)
    return alike.all(0).tolist(), int((~alike).sum())


def routed_logit_gate(what: str, got, want, same: list, tol, failures: list) -> dict:
    """Each row's logits within ``tol`` of its peak where both runs routed
    every token alike; a row whose routing took another expert at a near
    tie in some layer is counted and reported, not compared (other
    experts, other sums).  ``tol`` None: reported only."""
    rows = row_errors(got, want)
    kept = [e for e, s in zip(rows, same) if s]
    rec = {"rel_err_rows": rows, "same_routing_rows": same, "rows_compared": len(kept),
           "rows_routed_otherwise": len(rows) - len(kept),
           "rel_err_compared": max(kept) if kept else None,
           "rel_err_all": max(rows),
           "tolerance": None if tol is None else {"rel_per_row": tol}}
    if tol is not None and (not kept or max(kept) >= tol):
        failures.append(f"{what}: rows routed alike {len(kept)} of {len(rows)}, worst "
                        f"{rec['rel_err_compared']} (tolerance {tol})")
    return rec


def loop_vs_grouped(dev, cfg, params, plan, requests, decode_len: int, tol: float,
                    failures: list) -> tuple:
    """The loop server against the per-module grouped server on ``requests``
    (see ``phase_oracles``).  Returns (record, launch counts by path)."""
    import numpy as np

    n = len(requests)
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe")
    n_mb = -(-n // plan.b_a)
    runs = {}
    for path in ("grouped", "loop"):
        holder = torch.empty((n, cfg.vocab_size), dtype=params["embed"].dtype, device=dev)
        routes = torch.zeros((n_moe, n, cfg.experts_per_token), dtype=torch.long, device=dev)
        runs[path] = (served(dev, cfg, params, plan, requests,
                             {"decode_len": decode_len, "expert_path": path}, fused=False,
                             phase="oracles", taps=first_tick_tap(holder, routes)),
                      holder, routes)
    (g, g_lg, g_rt), (lp, l_lg, l_rt) = runs["grouped"], runs["loop"]
    same = same_routing(l_rt, g_rt)
    ticks = g["ticks"]
    tg, tl = np.stack(g["tokens"]), np.stack(lp["tokens"])
    g_launch, l_launch = g["seen"]["stats"].expert_launches, lp["seen"]["stats"].expert_launches
    what = f"oracles {params['embed'].dtype}: first decode tick, loop vs grouped"
    rec = {"phase": "oracles", "run": "loop vs per-module grouped",
           "dtype": str(params["embed"].dtype), "requests": n, "decode_len": decode_len,
           "B": plan.B, "b_a": plan.b_a, "b_e": plan.b_e, "decode_ticks": ticks,
           "first_tokens_equal": bool(np.array_equal(tg[:, 0], tl[:, 0])),
           "token_match": float((tg == tl).mean()),
           "first_tick_logits": routed_logit_gate(what, l_lg, g_lg, same[0], tol, failures),
           "first_tick_routing_decisions": {"differ": same[1], "of": n_moe * n},
           "expert_launches": {"grouped": g_launch, "loop": l_launch},
           "expert_tokens_loop": lp["seen"]["stats"].expert_tokens,
           "loop_planned_reads": lp["planned_reads"], "loop_decode_syncs": lp["syncs"],
           "grouped_decode_syncs": g["syncs"],
           "wall_s": {"grouped": g["wall_s"], "loop": lp["wall_s"]},
           "decode_s": {"grouped": g["report"].decode_s, "loop": lp["report"].decode_s},
           "decode_tok_s": {"grouped": g["report"].decode_throughput,
                            "loop": lp["report"].decode_throughput},
           "launches": {"grouped": g["counts"], "loop": lp["counts"]}}
    if not rec["first_tokens_equal"]:
        failures.append(f"{what}: the first tokens differ (both prefill grouped)")
    if g_launch != n_moe * ticks or l_launch < g_launch:
        failures.append(f"{what}: expert launches grouped {g_launch} (want {n_moe} x "
                        f"{ticks}), loop {l_launch}")
    if lp["syncs"] or lp["planned_reads"] != n_moe * ticks or lp["fused_ticks"] \
            or g["fused_ticks"]:
        failures.append(f"{what}: the loop decode made host syncs {lp['syncs']} or "
                        f"{lp['planned_reads']} planned reads (want {n_moe * ticks}), or a "
                        f"per-module run was fused")
    if dev.type == "cuda" and (lp["counts"]["expert_gate_up"] != n_moe * n_mb
                               or g["counts"]["expert_gate_up"] != n_moe * (n_mb + ticks)):
        failures.append(f"{what}: K1 launches loop {lp['counts']['expert_gate_up']} (want "
                        f"the prefill's {n_moe} x {n_mb}), grouped "
                        f"{g['counts']['expert_gate_up']}")
    return rec, {"grouped": g["counts"], "loop": lp["counts"]}


def prefill_routes(calls: list, lengths, S: int, n_mb: int, b_a: int, live_only: bool):
    """Per MoE layer and request, the (len, k) expert ids of its positions,
    from the ids each ``route`` call of a prefill recorded (layers outer,
    micro-batches inner; the grouped prefill routes only the positions below
    each row's length, the dense combine every position)."""
    import numpy as np

    out = []
    for li in range(len(calls) // n_mb):
        per = []
        for j in range(n_mb):
            idx = calls[li * n_mb + j]
            lens = lengths[j * b_a:(j + 1) * b_a]
            if live_only:
                per.extend(np.split(idx, np.cumsum(lens)[:-1]))
            else:
                idx = idx.reshape(len(lens), S, -1)
                per.extend(idx[r, :lens[r]] for r in range(len(lens)))
        out.append(per)
    return out


def exact_vs_grouped_prefill(dev, cfg, params, plan, requests, decode_len: int, tol: float,
                             failures: list) -> tuple:
    """``grouped_prefill=False`` against the grouped prefill (see
    ``phase_oracles``).  Returns (record, the exact prefill's launches)."""
    import numpy as np

    from repro_torch import analysis
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.kernels import ops

    n = len(requests)
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe")
    n_mb = -(-n // plan.b_a)
    prompts, lengths = padded_prompts(requests)
    S = prompts.shape[1]
    pre = {}
    for grouped in (True, False):
        before = torch.cuda.memory_allocated()
        eng = ModuleBatchingEngine(cfg, params, plan, max_seq=S + decode_len, device=dev,
                                   grouped_prefill=grouped, fused_decode=False)
        ops.reset_launch_counts()
        calls = []
        with analysis.sanitize(strict=False) as san, \
                routes_recorded(lambda idx: calls.append(idx.cpu().numpy())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = eng.prefill(prompts, lengths=lengths)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        pre[grouped] = {"logits": lg.float().cpu(), "ms": ms, "launches": ops.launch_counts(),
                        "probes": san.report()["planned_transfers"].get(
                            "prefill-capacity-probe", 0),
                        "routes": prefill_routes(calls, lengths, S, n_mb, plan.b_a, grouped)}
        del eng, lg
        freed("oracles", f"grouped_prefill={grouped} engine", before)
    differ = [[int((np.sort(a[r], -1) != np.sort(b[r], -1)).any(-1).sum()) for r in range(n)]
              for a, b in zip(pre[True]["routes"], pre[False]["routes"])]   # (layer, row)
    same = [not any(d[r] for d in differ) for r in range(n)]
    what = f"oracles {params['embed'].dtype}: exact vs grouped prefill"
    rec = {"phase": "oracles", "run": "grouped_prefill=False vs grouped prefill",
           "dtype": str(params["embed"].dtype), "prefill_tokens": int(lengths.sum()),
           "micro_batches": n_mb,
           "last_token_logits": routed_logit_gate(what, pre[False]["logits"], pre[True]["logits"],
                                           same, tol, failures),
           "routing_decisions": {"differ": int(sum(map(sum, differ))),
                                 "of": n_moe * int(lengths.sum())},
           "capacity_probes": {"grouped": pre[True]["probes"], "exact": pre[False]["probes"]},
           "prefill_ms": {"grouped": pre[True]["ms"], "exact": pre[False]["ms"]},
           "launches": {"grouped": pre[True]["launches"], "exact": pre[False]["launches"]}}
    if pre[False]["probes"] != 0 or pre[True]["probes"] != n_moe * n_mb:
        failures.append(f"{what}: capacity probes exact {pre[False]['probes']} (want 0), "
                        f"grouped {pre[True]['probes']} (want {n_moe} x {n_mb})")
    return rec, pre[False]["launches"]


def phase_oracles(dev, params):
    """The engine's reference oracles on full-size OLMoE-1B-7B:
    ``ORACLE_REQUESTS`` requests of 64..256 tokens, decode ``ORACLE_DECODE``,
    B = b_e = ORACLE_REQUESTS, on serve's bf16 weights and then on the same
    seed's f32 weights (27.7 GB).

    1. The loop expert path (``expert_path='loop'``: the routing read to the
       host once a MoE layer and tick, one ``torch.matmul`` chain per expert
       and chunk) against the per-module grouped server: the same first
       tokens (both prefill grouped), grouped expert launches n_moe x ticks
       and the loop's at least that, K1 launched only by the loop's prefill,
       no host sync in the loop's decode chunks but its planned reads
       (n_moe x ticks), and the first decode tick's logits within the row
       tolerance (bf16 0.02, f32 1e-3 of each row's peak) on every row that
       both runs routed alike in every layer (``routed_logit_gate``); the share of
       equal tokens printed.
    2. ``grouped_prefill=False`` (the dense-combine prefill) against the
       grouped prefill: 0 capacity probes against n_moe x micro-batches, and
       the last-token logits under the same gate in f32 (a row counts as
       routed alike when every one of its positions took the same experts in
       every layer); in bf16 the logits and the routing decisions that
       differ are reported only (with ~2500 positions x 16 layers every
       row has some near tie routed otherwise).
    3. (bf16) ``greedy_generate`` (model-based batching) on ORACLE_REQUESTS
       equal prompts of ORACLE_PROMPT tokens against the engine's per-module
       oracle: the share of equal tokens and both decode tok/s (no gate on
       speed).
    Every number is printed before any gate is read.  Returns each run's
    launch counts."""
    import numpy as np

    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.generate import greedy_generate

    cfg, plan, lens, decode_len = serve_setup(short_lengths(ORACLE_REQUESTS), ORACLE_DECODE)
    n = len(lens)
    requests = synthetic_requests(DatasetSpec("oracles", n, max(lens), decode_len),
                                  cfg.vocab_size, seed=5, prompt_lens=lens)
    launches, failures = {}, []
    # 1-2 on serve's bf16 weights
    rec, counts = loop_vs_grouped(dev, cfg, params, plan, requests, decode_len, REL_BF16,
                                  failures)
    emit(rec)
    launches.update({f"oracles_{k}": v for k, v in counts.items()})
    # (in bf16 every row has some position routed otherwise, so the logits
    # are reported only; the f32 run below gates every row)
    rec, launches["oracles_exact_prefill"] = exact_vs_grouped_prefill(
        dev, cfg, params, plan, requests, decode_len, None, failures)
    emit(rec)
    # 3. greedy_generate (model-based batching) against the per-module oracle
    _, eq_plan, eq_lens, _ = serve_setup([ORACLE_PROMPT] * n, decode_len)
    eq = synthetic_requests(DatasetSpec("oracles-greedy", n, ORACLE_PROMPT, decode_len),
                            cfg.vocab_size, seed=6, prompt_lens=eq_lens)
    toks = torch.from_numpy(padded_prompts(eq)[0]).to(dev)
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = greedy_generate(cfg, params, toks, decode_len).cpu().numpy()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches["oracles_greedy"] = ops.launch_counts()
    t0 = time.perf_counter()
    lg, caches = M.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del lg, caches
    freed("oracles", "greedy_generate", before)
    want, oracle_counts, timing = per_module_oracle(dev, cfg, params, eq_plan, eq, decode_len,
                                                    "oracles")
    greedy_decode_s = total_s - prefill_s
    emit({"phase": "oracles", "run": "greedy_generate vs per-module engine",
          "requests": n, "prompt_len": ORACLE_PROMPT, "decode_len": decode_len,
          "token_match": float((got == want).mean()),
          "first_tokens_equal": bool(np.array_equal(got[:, 0], want[:, 0])),
          "model_based": {"total_s": total_s, "prefill_s": prefill_s,
                          "decode_s": greedy_decode_s,
                          "decode_tok_s": n * (decode_len - 1) / greedy_decode_s},
          "module_based": timing, "launches": {"greedy": launches["oracles_greedy"],
                                               "per_module": oracle_counts},
          "nvidia_smi": gpu_line()})
    del toks
    if got.shape != (n, decode_len) or got.min() < 0 or got.max() >= cfg.vocab_size:
        failures.append(f"oracles: greedy_generate gave {got.shape} tokens out of range")
    if dev.type == "cuda" and not (launches["oracles_greedy"]["flash_attention"] > 0
                                   and launches["oracles_greedy"]["decode_attention"] > 0):
        failures.append(f"oracles: greedy_generate did not run K4 and K3: "
                        f"{launches['oracles_greedy']}")
    # 1-2 again in f32: the same seed's weights before their bf16 rounding
    cfg32 = replace(cfg, dtype="float32")
    before = torch.cuda.memory_allocated()
    p32 = M.init_params(cfg32, seed=0, device=dev)
    rec, counts = loop_vs_grouped(dev, cfg32, p32, plan, requests, decode_len, TOL_ORACLE_F32,
                                  failures)
    emit(rec)
    rec, _ = exact_vs_grouped_prefill(dev, cfg32, p32, plan, requests, decode_len,
                                      TOL_ORACLE_F32, failures)
    emit(rec)
    del p32
    freed("oracles", "the f32 weights", before)
    if failures:
        raise AssertionError("oracles: " + "; ".join(failures))
    return launches


def prime_backward(dev) -> None:
    """Autograd runs a CUDA backward (and a checkpointed recompute) on its own
    device thread, whose cuBLAS handle keeps a workspace for the life of the
    process: make it before the train phase reads its memory, as ``prime``
    does for the main thread."""
    from torch.utils.checkpoint import checkpoint

    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones((8, 8), dtype=dt, device=dev, requires_grad=True)
        body = lambda t: torch.bmm((torch.addmm(t[0], t, t) @ t)[None], t[None])  # noqa: E731
        checkpoint(body, a, use_reentrant=False).sum().backward()
    torch.cuda.synchronize()


def train_batch(cfg, B: int, S: int, dev, seed: int = 0):
    """One seeded synthetic (tokens, labels) batch on ``dev``."""
    import numpy as np

    from repro_torch.data.datasets import synthetic_batches

    t, lab = next(synthetic_batches(cfg.vocab_size, B, S, seed=seed))
    return (torch.from_numpy(t.astype(np.int64)).to(dev),
            torch.from_numpy(lab.astype(np.int64)).to(dev))


def loss_and_grads(cfg, params, tokens, labels, **kw):
    """``loss_fn`` and the gradient of every leaf (the parameters require grad)."""
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(params)
    total, _ = M.loss_fn(cfg, params, tokens, labels, **kw)
    return total.detach(), torch.autograd.grad(total, leaves)


def phase_train(dev):
    """Training on the card: OLMoE-1B-7B at full width and ``TRAIN_LAYERS``
    layers, bf16, ``TRAIN_B`` x ``TRAIN_S`` tokens, ``TRAIN_STEPS`` steps of
    ``train_step`` (loss with remat "full", autograd, AdamW in place) on one
    seeded batch: every loss and gnorm finite, the last loss below the first
    minus 0.2 (tests/test_train.py::test_loss_decreases), the median step
    (CUDA events), tokens/s and the peak memory beside the reckoning (12 B a
    parameter: bf16 weights and grads, f32 moments).  Then a checkpoint round
    trip of the trained base and first layer through the temporary
    directory, bit-exact, the file removed; at 2 layers, remat off, "full"
    and "dots" give the same loss and grads (each leaf's rows within 0.02 of
    their peak); at smoke size in f32 one train step on the card equals the
    CPU's (loss within 1e-4 relative, each grad within 1e-4 of its leaf's
    peak; the updated weights' largest difference printed in units of lr).  No kernel is launched (autograd refuses them),
    and the card's memory returns to its value before the phase."""
    import math
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import (
        adamw_init,
        adamw_update,
        tree_leaves,
        tree_map,
        tree_unflatten,
    )
    from repro_torch.train.train_loop import make_train_step

    prime_backward(dev)
    torch.cuda.empty_cache()
    launches0 = build.launch_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, labels = train_batch(cfg, TRAIN_B, TRAIN_S, dev)
    step = make_train_step(cfg, lr=TRAIN_LR, remat=True, remat_policy="full")
    metrics, events = [], []
    for _ in range(TRAIN_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, m = step(params, opt, tokens, labels)
        e1.record()
        metrics.append(m)
        events.append((e0, e1))
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["gnorm"]) for m in metrics]
    median_ms = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
          "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS, "lr": TRAIN_LR, "remat": "full",
          "params": n_params, "init_s": init_s, "loss": loss, "gnorm": gnorm,
          "aux": [float(m["aux"]) for m in metrics],
          "step_ms": [a.elapsed_time(b) for a, b in events], "median_step_ms": median_ms,
          "tokens_per_s": TRAIN_B * TRAIN_S / (median_ms / 1e3),
          "peak_allocated_gb": peak / 1e9,
          "reckoned_state_gb": n_params * 12 / 1e9, "nvidia_smi": gpu_line()})
    if not all(math.isfinite(x) for x in loss + gnorm):
        raise AssertionError(f"train: a loss or gnorm is not finite: {loss} {gnorm}")
    if not loss[-1] < loss[0] - 0.2:
        raise AssertionError(f"train: the loss fell from {loss[0]} to {loss[-1]} only")
    del metrics, events, m
    # checkpoint round trip of the trained base and first layer
    sub = {**{k: v for k, v in params.items() if k != "layers"}, "layers": params["layers"][:1]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(tmp, "ckpt.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, sub, step=TRAIN_STEPS)
        save_s, nbytes = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        restored, at = load_checkpoint(path, tree_map(torch.empty_like, sub))
        load_s = time.perf_counter() - t0
        exact = at == TRAIN_STEPS and all(
            a.dtype == b.dtype and torch.equal(a.detach(), b)
            for a, b in zip(tree_leaves(sub), tree_leaves(restored)))
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "train", "checkpoint": "base + layer 0 of the trained model",
          "params": sum(t.numel() for t in tree_leaves(sub)), "file_gb": nbytes / 1e9,
          "save_s": save_s, "load_s": load_s, "bit_exact": exact,
          "removed": not os.path.exists(tmp)})
    if not exact or os.path.exists(tmp):
        raise AssertionError("train: the checkpoint round trip is not bit-exact or its file "
                             "was not removed")
    del params, opt, sub, restored, step
    # remat off / "full" / "dots" at 2 layers, full width
    cfg2 = replace(cfg, num_layers=2)
    p2 = M.init_params(cfg2, seed=1, device=dev)
    for p in tree_leaves(p2):
        p.requires_grad_(True)
    ref_loss, ref_grads = loss_and_grads(cfg2, p2, tokens, labels, remat=False)
    remat = {}
    for policy in ("full", "dots"):
        lo, gr = loss_and_grads(cfg2, p2, tokens, labels, remat=True, remat_policy=policy)
        worst = max(errors(a, b)[1] for a, b in zip(gr, ref_grads))
        remat[policy] = {"loss": float(lo), "loss_rel": abs(float(lo - ref_loss)) /
                         abs(float(ref_loss)), "grad_rel_per_row": worst}
        del gr
    emit({"phase": "train", "remat": "off vs full vs dots", "layers": 2,
          "loss_off": float(ref_loss), **remat, "tolerance": {"rel_per_row": REL_BF16}})
    if not all(r["loss_rel"] < REL_BF16 and r["grad_rel_per_row"] < REL_BF16
               for r in remat.values()):
        raise AssertionError(f"train: remat policies disagree: {remat}")
    del p2, ref_loss, ref_grads, tokens, labels
    # one f32 train step at smoke size: card against CPU
    cfgs = replace(get_config(TRAIN_PARITY_ARCH, smoke=True), dtype="float32")
    cpu = M.init_params(cfgs, seed=2, device="cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    out = {}
    for where, p in (("card", card), ("cpu", cpu)):
        for t in tree_leaves(p):
            t.requires_grad_(True)
        toks, labs = train_batch(cfgs, 2, 32, p["embed"].device, seed=3)
        lo, gr = loss_and_grads(cfgs, p, toks, labs)
        adamw_update(p, tree_unflatten(p, gr), adamw_init(p), lr=1e-3)
        out[where] = (float(lo), [g.cpu() for g in gr], [t.detach().cpu() for t in tree_leaves(p)])
        del gr
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)  # noqa: E731
    parity = {"loss_rel": abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0]),
              "grad_rel": max(rel(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))}
    # AdamW's first step moves a weight by ~lr * sign(g): where g is near 0 its
    # sign is noise, so the updated weights are reported in units of lr
    step_diff = max(float((a - b).abs().max()) for a, b in zip(out["card"][2], out["cpu"][2]))
    del card, cpu, out
    launched = {k: v - launches0.get(k, 0) for k, v in build.launch_counts().items()
                if v != launches0.get(k, 0)}
    emit({"phase": "train", "card_vs_cpu": TRAIN_PARITY_ARCH + " smoke, f32", **parity,
          "tolerance": 1e-4, "updated_weights_max_diff_over_lr": step_diff / 1e-3,
          "kernel_launches_in_phase": launched})
    if not all(v < 1e-4 for v in parity.values()):
        raise AssertionError(f"train: card and CPU train steps differ: {parity}")
    if launched:
        raise AssertionError(f"train: kernels were launched during training: {launched}")
    freed("train", "training state", before)


# ---------------------------------------------------------------------------
# The model-sharding path: SHARDED_RANKS gloo rank processes on the one card
# ---------------------------------------------------------------------------
SHARDED_NOTE = ("two rank processes sharing one card on a (data 1, model 2) mesh, "
                "exchanging through host memory by gloo: no interconnect")
# f32 parity: OLMoE at full width, 2 layers, capacity factor 32 (no drop), 2 x
# 512 tokens (the psum capacity path); ZeRO-1 on (data 2, model 1) at 1 layer.
# bf16 serving: OLMoE at 4 layers, 16 prompts of 64..256 (right-padded to 256),
# 16 tokens, capacity factor E / k (no routed copy dropped, as b_e = B in the
# serve phases: a dropped copy is another function, not a rounding).
# f32 serving: the same prompts through greedy_generate(ctx) at 2 layers, every
# step's logits (the prefill's and each decode tick's) and every token held to
# one process.  Mamba2-370M: 8 x 1024 at 2 layers (bf16, gated) and all 48:
# in f32 gated to one process, in bf16 against one process's f32 run beside
# one process's own bf16 run (the witness of what bf16 rounding does there).
# Training: OLMoE at 4 layers, 4 x 512, remat full, 6 steps at 1e-4, capacity
# factor 1.25.
SHARDED = {"parity_layers": 2, "parity_B": 2, "parity_S": 512, "serve_layers": 4,
           "serve_prompts": 16, "serve_min": 64, "serve_max": 256, "serve_decode": 16,
           "serve_f32_layers": 2, "ssm_B": 8, "ssm_S": 1024, "ssm_layers": 2,
           "train_layers": 4, "train_B": 4, "train_S": 512, "train_steps": 6,
           "train_lr": 1e-4}
TOL_SHARDED_F32 = 1e-4
TOL_ZERO1 = 1e-6
# f32 greedy_generate(ctx): each step's logits per row over the row's peak
TOL_SERVE_F32 = 1e-3
# Mamba2 at 48 layers in bf16: the sharded run's distance from one process's
# f32 run at most this many times one process's own bf16 run's distance
SSM_BF16_WITNESS_RATIO = 2.0


def sharded_parity(dev, ctx, cfg, B: int, S: int, rank: int) -> dict:
    """f32: the sharded forward's logits and ``loss_fn``'s loss and
    gradients (summed, gathered) against the single-process run of rank 0 on
    the same card (it runs both; the other rank waits at its first
    collective)."""
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import gather_params, shard_params
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    full = M.init_params(cfg, seed=11, device=dev)
    toks, labels = train_batch(cfg, B, S, dev, seed=5)
    ref = {}
    if rank == 0:
        with torch.no_grad():
            ref["logits"] = M.forward(cfg, full, toks)[0]
        for t in tree_leaves(full):
            t.requires_grad_(True)
        ref["loss"], ref["grads"] = loss_and_grads(cfg, full, toks, labels)
    local = shard_params(ctx, cfg, full)
    del full
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = M.forward(cfg, local, toks, ctx=ctx)[0]
    fwd_s = time.perf_counter() - t0
    for t in tree_leaves(local):
        t.requires_grad_(True)
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, local, toks, labels, ctx=ctx)
    bwd_s = time.perf_counter() - t0
    full_grads = tree_leaves(gather_params(ctx, cfg, tree_unflatten(local, list(grads))))
    out = {"loss": float(loss), "forward_s": fwd_s, "loss_and_grads_s": bwd_s}
    if rank == 0:
        out.update(
            logits_rel=errors(logits, ref["logits"])[0] / float(ref["logits"].abs().max()),
            loss_ref=float(ref["loss"]),
            loss_rel=abs(float(loss) - float(ref["loss"])) / abs(float(ref["loss"])),
            grad_rel=max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                         for a, b in zip(full_grads, ref["grads"])),
            leaves=len(full_grads))
    del ref, local, grads, full_grads, logits, loss
    return out


def sharded_zero1(dev, ctx, cfg) -> dict:
    """One ZeRO-1 AdamW step on ``ctx`` (data 2, model 1): each rank passes
    half of seeded gradients (the sum over data is the whole gradient,
    exactly); the updated weights against the unsharded ``adamw_update`` on
    the whole gradient, per leaf over its peak."""
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init, adamw_update, tree_leaves, tree_map

    params = M.init_params(cfg, seed=11, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    grads = tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=gen, device=dev,
                                                  dtype=torch.float32).to(p.dtype), params)
    want = tree_map(lambda p: p.clone(), params)
    _, _, gn_want = adamw_update(want, grads, adamw_init(want), lr=1e-3)
    opt = adamw_init(params, ctx, cfg)
    held = sum(t.numel() for t in tree_leaves(opt.mu))
    _, opt, gn = adamw_update(params, tree_map(lambda g: g / ctx.batch_size, grads), opt,
                              lr=1e-3, ctx=ctx, cfg=cfg)
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(tree_leaves(params), tree_leaves(want)))
    out = {"params": sum(t.numel() for t in tree_leaves(params)), "moment_elems_held": held,
           "rel_err_per_leaf_peak": rel,
           "gnorm_rel": abs(float(gn) - float(gn_want)) / float(gn_want)}
    del params, grads, want, opt
    return out


@contextlib.contextmanager
def prefill_logits_tap(holder: list):
    """While active, ``models.model.prefill``'s logits go to ``holder``."""
    from repro_torch.models import model as M

    prefill = M.prefill

    def tapped(*a, **kw):
        logits, caches = prefill(*a, **kw)
        holder.append(logits[:, 0].float().cpu())
        return logits, caches

    M.prefill = tapped
    try:
        yield
    finally:
        M.prefill = prefill


@contextlib.contextmanager
def greedy_logits_tap(holder: list):
    """While active, every logits ``serving.generate.greedy_generate`` picks
    a token from (the prefill's last position, then each decode tick's)
    goes to ``holder``, in f32 on the host."""
    from repro_torch.serving import generate as G

    greedy = G.greedy

    def tapped(logits):
        holder.append(logits.float().cpu())
        return greedy(logits)

    G.greedy = tapped
    try:
        yield
    finally:
        G.greedy = greedy


@contextlib.contextmanager
def single_capacity_path():
    """While active, one process's MoE layers run the capacity dispatch
    (``moe_apply_grouped``: K1 + K2 on the card) in place of the dense
    combine, at the sharded path's capacity, so that a comparison with the
    sharded psum path differs only by its cross-rank sums."""
    from repro_torch.models import moe as moe_mod

    local = moe_mod.moe_apply_local
    moe_mod.moe_apply_local = lambda cfg, p, x: moe_mod.moe_apply_grouped(cfg, p, x)
    try:
        yield
    finally:
        moe_mod.moe_apply_local = local


def sharded_prompts(cfg, dev, n: int, lo: int, hi: int):
    """``n`` seeded prompts of ``lo``..``hi`` tokens, right-padded with token
    0 to ``hi`` (greedy_generate, like the reference's, takes no lengths)."""
    import numpy as np

    rng = np.random.default_rng(7)
    toks = np.zeros((n, hi), np.int64)
    for i in range(n):
        ln = lo + ((hi - lo) * i) // max(n - 1, 1)
        toks[i, :ln] = rng.integers(1, cfg.vocab_size, ln)
    return torch.from_numpy(toks).to(dev)


def sharded_serve(dev, ctx, cfg, size: dict, rank: int) -> dict:
    """bf16 serving through ``greedy_generate(ctx)``, beside rank 0's
    single-process run: first-token logits, every routing decision of the
    prefill and the first decode step (this rank's rows; under seq_shard
    its half of each prompt), tokens; K4, K1 + K2 and K3 launch counts and
    local shapes, their largest calls captured (rank 0)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.generate import greedy_generate
    from repro_torch.sharding.specs import shard_params

    full = M.init_params(cfg, seed=0, device=dev)
    toks = sharded_prompts(cfg, dev, size["serve_prompts"], size["serve_min"],
                           size["serve_max"])
    T = size["serve_decode"]
    out = {}
    if rank == 0:
        routes, logits = [], []
        with torch.no_grad(), routes_recorded(lambda i: routes.append(i.cpu())), \
                prefill_logits_tap(logits):
            t0 = time.perf_counter()
            ref = greedy_generate(cfg, full, toks, T)
            out["single_s"] = time.perf_counter() - t0
        out.update(single_tokens=ref.cpu(), single_routes=routes[:2 * cfg.num_layers],
                   single_logits=logits[0])
        # one process on the sharded path's MoE arithmetic (capacity + K1/K2)
        routes, logits = [], []
        with torch.no_grad(), routes_recorded(lambda i: routes.append(i.cpu())), \
                prefill_logits_tap(logits), single_capacity_path():
            ref = greedy_generate(cfg, full, toks, T)
        out.update(capacity_tokens=ref.cpu(), capacity_routes=routes[:cfg.num_layers],
                   capacity_logits=logits[0])
        del ref
    local = shard_params(ctx, cfg, full)
    del full
    routes, logits = [], []
    ops.reset_launch_counts()
    with torch.no_grad(), routes_recorded(lambda i: routes.append(i.cpu())), \
            prefill_logits_tap(logits), capture_calls(
                ("grouped_expert_ffn", "flash_attention", "decode_attention")) as calls:
        t0 = time.perf_counter()
        got = greedy_generate(cfg, local, toks, T, ctx=ctx)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["sharded_s"] = time.perf_counter() - t0
    out.update(counts=ops.launch_counts(), tokens=got.cpu(),
               routes=routes[:2 * cfg.num_layers], logits=logits[0],
               local_shapes={n: [tuple(t.shape) for t in a if torch.is_tensor(t)][:2]
                             for n, (a, _) in calls.items()})
    if rank == 0:
        out["calls"] = {n: ([t.cpu() if torch.is_tensor(t) else t for t in a],
                            {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
                        for n, (a, kw) in calls.items()}
    del local, got, calls, toks
    return out


def sharded_serve_f32(dev, ctx, cfg, size: dict, rank: int) -> dict:
    """f32 ``greedy_generate(ctx)`` beside rank 0's single-process run on the
    same prompts: rank 0 returns, per step (the prefill's, then each decode
    tick's), each row's logits error over its peak, and both runs' tokens;
    every rank its tokens and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.generate import greedy_generate
    from repro_torch.sharding.specs import shard_params

    full = M.init_params(cfg, seed=0, device=dev)
    toks = sharded_prompts(cfg, dev, size["serve_prompts"], size["serve_min"],
                           size["serve_max"])
    T = size["serve_decode"]
    out, want = {}, []
    if rank == 0:
        with torch.no_grad(), greedy_logits_tap(want):
            out["single_tokens"] = greedy_generate(cfg, full, toks, T).cpu()
    local = shard_params(ctx, cfg, full)
    del full
    got = []
    ops.reset_launch_counts()
    with torch.no_grad(), greedy_logits_tap(got):
        out["tokens"] = greedy_generate(cfg, local, toks, T, ctx=ctx).cpu()
    out["counts"] = ops.launch_counts()
    if rank == 0:
        out["step_rows"] = [row_errors(g, w) for g, w in zip(got, want)]
    del local, toks, got, want
    return out


def sharded_ssm(dev, ctx, cfg, B: int, S: int, rank: int, f32: bool = False) -> dict:
    """Mamba2's sharded prefill (nh/m heads a rank, K5 on them) beside rank
    0's single-process prefill: the last-token logits.  ``f32``: the same
    weights, cast, run again in f32, sharded and in one process (the f32
    runs' launches are counted apart)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import shard_params
    from repro_torch.train.optimizer import tree_map

    full = M.init_params(cfg, seed=0, device=dev)
    toks, _ = train_batch(cfg, B, S, dev, seed=9)
    cfg32 = replace(cfg, dtype="float32")
    out = {}
    if rank == 0:
        with torch.no_grad():
            t0 = time.perf_counter()
            out["single_logits"] = M.prefill(cfg, full, toks)[0][:, 0].float().cpu()
            out["single_s"] = time.perf_counter() - t0
            if f32:
                out["single_f32_logits"] = M.prefill(
                    cfg32, tree_map(lambda t: t.float(), full), toks)[0][:, 0].cpu()
    local = shard_params(ctx, cfg, full)
    del full
    ops.reset_launch_counts()
    with torch.no_grad(), capture_calls(("ssd_scan",)) as calls:
        t0 = time.perf_counter()
        logits = M.prefill(cfg, local, toks, ctx=ctx)[0][:, 0].float().cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["sharded_s"] = time.perf_counter() - t0
    out.update(counts=ops.launch_counts(), logits=logits,
               local_shapes={n: [tuple(t.shape) for t in a if torch.is_tensor(t)][:1]
                             for n, (a, _) in calls.items()})
    if rank == 0:
        out["calls"] = {n: ([t.cpu() if torch.is_tensor(t) else t for t in a],
                            {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
                        for n, (a, kw) in calls.items()}
    if f32:
        ops.reset_launch_counts()
        with torch.no_grad():
            out["f32_logits"] = M.prefill(cfg32, tree_map(lambda t: t.float(), local), toks,
                                          ctx=ctx)[0][:, 0].cpu()
        out["f32_counts"] = ops.launch_counts()
    del local, calls, toks
    return out


def sharded_train(dev, ctx, cfg, size: dict) -> dict:
    """Sharded training: this rank's shares, seq_shard, ZeRO-1 AdamW, remat
    full, on one seeded batch; each step's host wall (synchronised), loss,
    the collectives' calls, bytes and host seconds; the peak memory."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import shard_params
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    from repro_torch.train.train_loop import make_train_step

    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    local = shard_params(ctx, cfg, M.init_params(cfg, seed=0, device=dev))
    n_local = sum(t.numel() for t in tree_leaves(local))
    for t in tree_leaves(local):
        t.requires_grad_(True)
    opt = adamw_init(local, ctx, cfg)
    tokens, labels = train_batch(cfg, size["train_B"], size["train_S"], dev)
    step = make_train_step(cfg, lr=size["train_lr"], remat=True, remat_policy="full", ctx=ctx)
    steps = []
    for _ in range(size["train_steps"]):
        C.reset_stats()
        t0 = time.perf_counter()
        local, opt, m = step(local, opt, tokens, labels)
        loss = float(m["loss"])
        if card:
            torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                      "gnorm": float(m["gnorm"]), "collectives": C.STATS["calls"],
                      "collective_bytes": C.STATS["bytes"],
                      "collective_host_ms": C.STATS["host_s"] * 1e3})
    peak = torch.cuda.max_memory_allocated() if card else 0
    del local, opt, m, tokens, labels, step
    return {"steps": steps, "params_per_rank": n_local, "peak_gb": peak / 1e9,
            "reckoned_gb": 12 * n_local / 1e9}


def sharded_rank(rank: int, n: int, group, device: str, cfgs: dict, size: dict) -> dict:
    """One rank of the ``sharded`` phase, in its own process on the card:
    the parts in turn, each rank's allocated bytes back to their start after
    each (on the CPU, for a rehearsal, nothing to count)."""
    from repro_torch.launch import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = dev.type == "cuda"
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    allocated = torch.cuda.memory_allocated if card else (lambda: 0)
    if card:
        prime(dev)
        prime_backward(dev)
    ctx = mesh.make_ctx(mesh.make_debug_mesh(1, n), seq_shard=True)
    ctx_data = mesh.make_ctx(mesh.make_debug_mesh(n, 1))
    out, left = {}, {}
    parts = [
        ("parity", lambda: sharded_parity(dev, ctx, cfgs["parity"], size["parity_B"],
                                          size["parity_S"], rank)),
        ("zero1", lambda: sharded_zero1(dev, ctx_data, cfgs["zero1"])),
        ("serve", lambda: sharded_serve(dev, ctx, cfgs["serve"], size, rank)),
        ("serve_f32", lambda: sharded_serve_f32(dev, ctx, cfgs["serve_f32"], size, rank)),
        ("ssm", lambda: sharded_ssm(dev, ctx, cfgs["ssm"], size["ssm_B"], size["ssm_S"],
                                    rank)),
        ("ssm_full", lambda: sharded_ssm(dev, ctx, cfgs["ssm_full"], size["ssm_B"],
                                         size["ssm_S"], rank, f32=True)),
        ("train", lambda: sharded_train(dev, ctx, cfgs["train"], size)),
    ]
    for name, part in parts:
        before = allocated()
        t0 = time.perf_counter()
        out[name] = part()
        out[name]["wall_s"] = time.perf_counter() - t0
        left[name] = allocated() - before
    out["left_bytes"] = left
    return out


def phase_sharded(dev):
    """The model-sharding path on ``SHARDED_RANKS`` gloo rank processes
    sharing the card (``sharded_rank``): f32 parity of the sharded forward,
    loss and gradients with a single-process run (1e-4); one ZeRO-1 step
    (1e-6 of each leaf's peak); bf16 ``greedy_generate(ctx)``: first-token
    logits within 0.02 of the row peak, every routing decision of the
    prefill and the first decode step reported (and against one process on
    the same capacity arithmetic), the share of equal tokens; K4, K1 + K2
    and K3 launched at the local shapes (8 of 16 heads, 32 of 64 experts),
    every launch the served design; f32 ``greedy_generate(ctx)``: every
    step's logits within 1e-3 of the row peak, every token equal; Mamba2's
    sharded prefill within 0.02 at 2 layers (K5 at 16 of 32 heads), at all
    48 within 1e-4 in f32 and, in bf16, within twice one process's own bf16
    distance from f32; training whose loss falls.  Each
    part frees its memory on each rank.  Then each kernel is held to its
    plain version on rank 0's captured inputs.  Returns ({path: launch
    counts}, kernel rows)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh

    size = dict(SHARDED)
    olmoe = get_config("olmoe-1b-7b")
    cfgs = {"parity": replace(olmoe, num_layers=size["parity_layers"], dtype="float32",
                              capacity_factor=32.0),
            "zero1": replace(olmoe, num_layers=1, dtype="float32"),
            "serve": replace(olmoe, num_layers=size["serve_layers"],
                             capacity_factor=olmoe.num_experts / olmoe.experts_per_token),
            "serve_f32": replace(olmoe, num_layers=size["serve_f32_layers"], dtype="float32",
                                 capacity_factor=olmoe.num_experts / olmoe.experts_per_token),
            "ssm": replace(get_config(SSM_ARCH), num_layers=size["ssm_layers"]),
            "ssm_full": get_config(SSM_ARCH),
            "train": replace(olmoe, num_layers=size["train_layers"])}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = mesh.spawn(sharded_rank, SHARDED_RANKS, (dev.type, cfgs, size),
                      timeout_s=900.0, group_timeout_s=300.0)
    wall = time.perf_counter() - t0
    card = dev.type == "cuda"
    failures = []
    r0 = outs[0]
    # f32 parity and ZeRO-1
    par, zero = r0["parity"], [o["zero1"] for o in outs]
    emit({"phase": "sharded", "part": "parity", "card": gpu_line(), "note": SHARDED_NOTE,
          "arch": cfgs["parity"].name, "layers": size["parity_layers"], "dtype": "float32",
          "B": size["parity_B"], "S": size["parity_S"],
          **{k: v for k, v in par.items()}, "tolerance": TOL_SHARDED_F32})
    emit({"phase": "sharded", "part": "zero1", "mesh": {"data": SHARDED_RANKS, "model": 1},
          "ranks": zero, "tolerance": TOL_ZERO1})
    if not (par["logits_rel"] < TOL_SHARDED_F32 and par["loss_rel"] < TOL_SHARDED_F32
            and par["grad_rel"] < TOL_SHARDED_F32):
        failures.append(f"f32 parity: {par}")
    if not all(z["rel_err_per_leaf_peak"] < TOL_ZERO1 for z in zero):
        failures.append(f"ZeRO-1 step: {zero}")
    # bf16 serving
    sv = [o["serve"] for o in outs]
    L = cfgs["serve"].num_layers
    single = torch.stack(sv[0]["single_routes"][:L])             # (L, B*S, k)
    Bp, Sp = size["serve_prompts"], size["serve_max"]
    k = cfgs["serve"].experts_per_token
    halves = [torch.stack(s["routes"][:L]).reshape(L, Bp, -1, k) for s in sv]
    sharded_prefill = torch.cat(halves, dim=2).reshape(L, Bp * Sp, k)
    pre_same, pre_diff = same_routing(sharded_prefill, single)
    # a row's first-token logits come from its last position: gated where that
    # position took the same experts in every layer (a near tie elsewhere is
    # reported in the decision count)
    alike = (sharded_prefill.sort(-1).values == single.sort(-1).values).all(-1)
    row_alike = alike.reshape(L, Bp, Sp)[:, :, -1].all(0).tolist()
    tick_same, tick_diff = same_routing(torch.stack(sv[0]["routes"][L:2 * L]),
                                        torch.stack(sv[0]["single_routes"][L:2 * L]))
    gate = routed_logit_gate("sharded first-token logits", sv[0]["logits"],
                             sv[0]["single_logits"], row_alike, REL_BF16, failures)
    toks_equal = float((sv[0]["tokens"] == sv[0]["single_tokens"]).float().mean())
    ranks_agree = all(torch.equal(s["tokens"], sv[0]["tokens"]) for s in sv)
    # one process on the same MoE arithmetic (capacity + K1/K2): only the
    # sums across ranks differ
    _, cap_diff = same_routing(sharded_prefill, torch.stack(sv[0]["capacity_routes"]))
    _, cap_vs_dense = same_routing(torch.stack(sv[0]["capacity_routes"]), single)
    cap_rows = row_errors(sv[0]["logits"], sv[0]["capacity_logits"])
    emit({"phase": "sharded", "part": "serve", "arch": cfgs["serve"].name, "layers": L,
          "prompts": Bp, "prompt_lens": [size["serve_min"], size["serve_max"]],
          "decode": size["serve_decode"], "first_token": gate,
          "prefill_decisions": int(single.shape[1]) * L,
          "prefill_decisions_differing": pre_diff,
          "first_tick_decisions_differing": tick_diff,
          "single_capacity_path": {
              "prefill_decisions_differing_from_sharded": cap_diff,
              "prefill_decisions_differing_from_dense": cap_vs_dense,
              "first_token_rel_err_rows_sharded": cap_rows,
              "token_share_equal_sharded": float(
                  (sv[0]["tokens"] == sv[0]["capacity_tokens"]).float().mean())},
          "token_share_equal": toks_equal, "ranks_tokens_equal": ranks_agree,
          "single_s": sv[0]["single_s"], "sharded_s": [s["sharded_s"] for s in sv],
          "launches": [s["counts"] for s in sv], "local_shapes": sv[0]["local_shapes"]})
    if not ranks_agree:
        failures.append("bf16 serving: the ranks' tokens differ")
    H, E = cfgs["serve"].num_heads, cfgs["serve"].num_experts
    for r, s in enumerate(sv):
        c, shp = s["counts"], s["local_shapes"]
        want = {"flash_attention": L, "expert_gate_up": L, "grouped_matmul": L,
                "decode_attention": L * (size["serve_decode"] - 1)}
        if card and (any(c.get(kk, 0) != v for kk, v in want.items())
                     or any(c[kk] != c[f"{kk}_{d}"] for kk, d in NEW_DESIGNS if c.get(kk))
                     or shp["flash_attention"][0][2] != H // SHARDED_RANKS
                     or shp["grouped_expert_ffn"][0][0] != E // SHARDED_RANKS
                     or shp["decode_attention"][0][1] != H // SHARDED_RANKS):
            failures.append(f"rank {r} serve launches {c}, local shapes {shp}")
    # serving in f32: every step's logits and every token
    sf = [o["serve_f32"] for o in outs]
    steps_max = [max(rows) for rows in sf[0]["step_rows"]]
    f32_tokens = (torch.equal(sf[0]["tokens"], sf[0]["single_tokens"])
                  and all(torch.equal(s["tokens"], sf[0]["tokens"]) for s in sf))
    emit({"phase": "sharded", "part": "serve_f32", "arch": cfgs["serve_f32"].name,
          "layers": cfgs["serve_f32"].num_layers, "dtype": "float32", "prompts": Bp,
          "decode": size["serve_decode"], "steps_compared": len(steps_max),
          "rows_compared": sum(len(r) for r in sf[0]["step_rows"]),
          "rel_err_max_per_step": steps_max, "tokens_equal": f32_tokens,
          "launches": [s["counts"] for s in sf], "tolerance": {"rel_per_row": TOL_SERVE_F32}})
    if (len(steps_max) != size["serve_decode"] or max(steps_max) >= TOL_SERVE_F32
            or not f32_tokens):
        failures.append(f"f32 sharded serving: steps {steps_max}, tokens equal {f32_tokens}")
    # Mamba2: bf16 gated at 2 layers; at all 48, f32 gated to one process
    # and bf16 held against one process's own bf16 distance from f32
    nh = cfgs["ssm"].ssm_nheads
    for part in ("ssm", "ssm_full"):
        sm = [o[part] for o in outs]
        ssm_rows = row_errors(sm[0]["logits"], sm[0]["single_logits"])
        rec = {"phase": "sharded", "part": part, "arch": cfgs[part].name,
               "layers": cfgs[part].num_layers, "B": size["ssm_B"], "S": size["ssm_S"],
               "rel_err_max": max(ssm_rows), "rel_err_rows": ssm_rows,
               "single_s": sm[0]["single_s"], "sharded_s": [s["sharded_s"] for s in sm],
               "launches": [s["counts"] for s in sm], "local_shapes": sm[0]["local_shapes"]}
        if part == "ssm":
            rec["tolerance"] = {"rel_per_row": REL_BF16}
            if max(ssm_rows) >= REL_BF16:
                failures.append(f"Mamba2 sharded prefill rows {max(ssm_rows)}")
        else:
            f32_rows = row_errors(sm[0]["f32_logits"], sm[0]["single_f32_logits"])
            witness = max(row_errors(sm[0]["single_logits"], sm[0]["single_f32_logits"]))
            from_f32 = max(row_errors(sm[0]["logits"], sm[0]["single_f32_logits"]))
            rec.update(f32_rel_err_max=max(f32_rows), f32_rel_err_rows=f32_rows,
                       single_bf16_vs_f32=witness, sharded_bf16_vs_f32=from_f32,
                       f32_launches=[s["f32_counts"] for s in sm],
                       tolerance={"f32_rel_per_row": TOL_SHARDED_F32,
                                  "bf16_vs_f32_over_witness": SSM_BF16_WITNESS_RATIO})
            if max(f32_rows) >= TOL_SHARDED_F32:
                failures.append(f"Mamba2 f32 sharded prefill at {cfgs[part].num_layers} "
                                f"layers rows {max(f32_rows)}")
            if from_f32 > SSM_BF16_WITNESS_RATIO * witness:
                failures.append(f"Mamba2 bf16 sharded prefill {from_f32} from f32, one "
                                f"process's bf16 {witness}")
            if card and any(s["f32_counts"].get("ssd_scan") != cfgs[part].num_layers
                            for s in sm):
                failures.append(f"Mamba2 f32 launches {[s['f32_counts'] for s in sm]}")
        emit(rec)
        for r, s in enumerate(sm):
            c = s["counts"]
            if card and (c.get("ssd_scan") != cfgs[part].num_layers
                         or c.get("ssd_scan_mma") != c.get("ssd_scan")
                         or s["local_shapes"]["ssd_scan"][0][2] != nh // SHARDED_RANKS):
                failures.append(f"rank {r} Mamba2 {part} launches {c}, "
                                f"shapes {s['local_shapes']}")
    sm = [o["ssm_full"] for o in outs]
    # training
    tr = [o["train"] for o in outs]
    steps = tr[0]["steps"]
    ms = sorted(st["ms"] for st in steps[1:]) or [steps[0]["ms"]]
    med = ms[len(ms) // 2]
    emit({"phase": "sharded", "part": "train", "arch": cfgs["train"].name,
          "layers": size["train_layers"], "dtype": cfgs["train"].dtype, "B": size["train_B"],
          "S": size["train_S"], "steps": steps, "median_step_ms": med,
          "tokens_per_s": size["train_B"] * size["train_S"] / (med / 1e3),
          "peak_gb_per_rank": [t["peak_gb"] for t in tr],
          "reckoned_gb_per_rank": [t["reckoned_gb"] for t in tr],
          "params_per_rank": [t["params_per_rank"] for t in tr], "card": gpu_line()})
    loss = [st["loss"] for st in steps]
    if not all(torch.isfinite(torch.tensor(loss))) or not loss[-1] < loss[0]:
        failures.append(f"training loss {loss}")
    emit({"phase": "sharded", "spawn_wall_s": wall,
          "part_wall_s": {p: [o[p]["wall_s"] for o in outs]
                          for p in ("parity", "zero1", "serve", "serve_f32", "ssm",
                                    "ssm_full", "train")},
          "left_bytes": [o["left_bytes"] for o in outs]})
    if card and any(v for o in outs for v in o["left_bytes"].values()):
        failures.append(f"memory left after a part: {[o['left_bytes'] for o in outs]}")
    if failures:
        raise AssertionError("sharded: " + "; ".join(failures))
    # rank 0's captured inputs, back on the card (they crossed as host copies)
    on_card = lambda v: v.to(dev) if torch.is_tensor(v) else v  # noqa: E731
    calls = {(where, n): ([on_card(a) for a in args], {k: on_card(v) for k, v in kw.items()})
             for where, part in (("serve", sv[0]), ("ssm", sm[0]))
             for n, (args, kw) in part["calls"].items()}
    kernel_rows = check_path_kernels("sharded", calls)
    counts = dict(sv[0]["counts"])
    for kk, v in sm[0]["counts"].items():
        counts[kk] = counts.get(kk, 0) + v
    return counts, kernel_rows


def kernels_line(rows, launches, path_rows=None) -> list:
    """One entry per kernel, at the shape of the path it serves most: K1-K3
    the short serve path, K4 the long one, K5 the SSM one; "launches" is
    that path's count (from its static run), "launches_by_path" every
    path's.  ``path_rows`` ({path: rows of check_path_kernels}) adds, per
    kernel, its first row on that path's own inputs (e.g. Mixtral's)."""
    home = {"flash_attention": "serve_long", "ssd_scan": "serve_ssm",
            "decode_attention_paged": "serve_paged"}
    seen, line_rows = set(), []
    for r in rows:
        if r["name"] in seen:
            continue
        seen.add(r["name"])
        by_path = {k: c.get(r["name"], 0) for k, c in launches.items() if c}
        line_rows.append({
            "name": r["name"], "route": "cuda", "source": SOURCE[r["name"]],
            "replaces": REPLACES[r["name"]],
            "launches": by_path.get(home.get(r["name"], "serve")),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
            "tolerance": r["tolerance"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": r["case"],
            "design": r["design"],
            "prev_ms": r.get("prev_ms"), "ms_again": r.get("ms_again"),
        })
        if "k3_ms" in r:                       # K3p: K3 on the gathered copy
            line_rows[-1].update({"k3_ms": r["k3_ms"], "library": r["library"]})
        offsets = [x for x in rows if x["name"] == r["name"] and "q_offset" in x]
        if offsets:                            # K4 with a query offset (serve_prefix)
            line_rows[-1]["q_offset_cases"] = [
                {k: x.get(k) for k in ("case", "q_offset", "Sq", "design", "ms", "ms_again",
                                       "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err", "rel_err", "full_call_bit_identical")}
                for x in offsets]
        for path, prow in (path_rows or {}).items():
            mine = next((x for x in prow if x["name"] == r["name"]), None)
            if mine is not None:
                line_rows[-1][f"{path}_case"] = {
                    k: mine.get(k) for k in ("case", "design", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "max_abs_err",
                                             "rel_err")}
    return line_rows


def prime(dev) -> None:
    """Make what a process keeps for its life before any server is built, so
    that freeing a server is exact: cuBLAS's workspace per handle and stream
    (the default stream and the side stream engines capture their decode
    graphs on) and K3's per-device buffer of tickets."""
    from repro_torch.core.engine import capture_stream
    from repro_torch.kernels import ops

    for stream in (torch.cuda.current_stream(dev), capture_stream(dev)):
        with torch.cuda.stream(stream):
            for dt in (torch.bfloat16, torch.float32):
                a = torch.ones((8, 8), dtype=dt, device=dev)
                torch.addmm(a[0], a, a) @ a
                torch.bmm(a[None], a[None])
        torch.cuda.current_stream(dev).wait_stream(stream)
    z = torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16, device=dev)
    ops.decode_attention(z[:, 0], z, z, 0)
    torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,serve,serve_omega,serve_long,serve_paged,"
                                        "serve_prefix,serve_streamed,serve_faults,"
                                        "serve_replicas,serve_ep,oracles,train,sharded,"
                                        "serve_ssm,serve_mixtral,parity,profile")
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
    t_start = time.perf_counter()
    name, line = torch.cuda.get_device_name(0), gpu_line()
    emit({"phase": "device", "name": name, "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t_build = build.build_all()
    emit({"phase": "build", "seconds": t_build,
          "ptxas": {n: ptxas_summary(build.ptxas_log(n)) for n in build.SOURCES}})
    rows = []
    prime(dev)
    if "kernels" in phases:
        _, plan, lens, decode_len = serve_setup(short_lengths(), 32)
        long_plan = serve_setup(long_lengths(), LONG_DECODE)[1]
        ssm_plan = serve_setup(ssm_lengths(), SSM_DECODE, SSM_ARCH)[1]
        rows = phase_kernels(dev, plan, span=max(lens) + decode_len,
                             prompt_len=max(lens), long_b_a=long_plan.b_a,
                             ssm_b_a=ssm_plan.b_a)
        emit({"kernel_cases": rows})
    launches = {}                           # per path: counts from its static run
    path_rows = {}                          # per streamed path: its kernel rows
    if phases & {"serve", "serve_long", "serve_streamed", "serve_omega", "serve_paged",
                  "serve_prefix", "serve_faults", "serve_replicas", "serve_ep", "oracles"}:
        params = init_weights(dev)
        resident = long_reports = None
        if "serve" in phases:
            resident = phase_serve(dev, params, profile="profile" in phases)
            launches["serve"] = resident[0]["static"]
        if "serve_omega" in phases:
            launches["serve_omega"], _ = phase_serve_omega(dev, params, resident)
        if "serve_long" in phases:
            launches["serve_long"], long_reports = phase_serve_long(
                dev, params, profile="profile" in phases)
        if "serve_paged" in phases:
            launches["serve_paged"], path_rows["serve_paged"] = phase_serve_paged(
                dev, params, long_reports)
        if "serve_prefix" in phases:
            launches["serve_prefix"] = phase_serve_prefix(dev, params,
                                                          profile="profile" in phases)
        if "serve_streamed" in phases:
            launches["serve_streamed"], path_rows["serve_streamed"] = phase_serve_streamed(
                dev, params, resident)
        if "serve_faults" in phases:
            for run, counts in phase_serve_faults(dev, params, resident,
                                                  long_reports).items():
                launches[f"serve_faults_{run}"] = counts
        if "serve_replicas" in phases:
            launches["serve_replicas"] = phase_serve_replicas(dev, params)
        if "serve_ep" in phases:
            oracle = (None if resident is None else
                      [r.tokens for r in resident[1]["static"].request_results])
            launches["serve_ep"], path_rows["serve_ep"] = phase_serve_ep(dev, params, oracle)
        if "oracles" in phases:
            launches.update(phase_oracles(dev, params))
        del params, resident, long_reports
        torch.cuda.empty_cache()
    if "train" in phases:
        phase_train(dev)
        torch.cuda.empty_cache()
    if "sharded" in phases:
        launches["sharded"], path_rows["sharded"] = phase_sharded(dev)
        torch.cuda.empty_cache()
    if "serve_ssm" in phases:
        launches["serve_ssm"], _ = phase_serve_ssm(dev, profile="profile" in phases)
    if "serve_mixtral" in phases:
        launches["serve_mixtral"], path_rows["serve_mixtral"] = phase_serve_mixtral(dev)
    if "parity" in phases:
        phase_parity(dev)
    line_rows = kernels_line(rows, launches, path_rows)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if line_rows:
        emit({"kernels": line_rows})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
