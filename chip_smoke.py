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
               the kernels' launch counts are read around each run;
5. serve_long -- the same server and weights on 32 long prompts (1024..3584
               tokens, decode 64, max_seq 3648): prefill through K4 at every
               layer, decode through K3 at spans up to 3648; its own launch
               counts;
6. serve_ssm -- the server on full-width, full-depth Mamba2-370M (bf16,
               seeded, the planner's b_a): 128 prompts of 200..1800 tokens,
               decode 64, both schedulers; prefill through K5 at every layer,
               decode through the plain recurrent step;
7. parity   -- card (kernels) against CPU (plain versions), f32: OLMoE at
               full width but 2 layers (32 tokens, a ragged 1536-token
               prompt), Mamba2 at full width but 2 layers (600 and 300
               tokens), and the Jamba smoke config (one interleave period,
               lengths 100 and 77), which runs K1-K5 in one model.

After each serve phase a fresh engine prefills the same prompts and runs a
few decode ticks with the kernels' largest calls captured, and every kernel
is held to its plain version on those inputs (the path's own shapes: the
prefill capacity buffer, K4's and K5's micro-batch, a decode tick's FFN and
K3).  Every server is deleted without a ``gc.collect()``, and
``torch.cuda.memory_allocated()`` must fall back to what it was before the
server was built.  ``--phases kernels,serve,serve_long,serve_ssm,parity,
profile`` adds a torch.profiler breakdown of that decode tick and of one
prefill wave (not part of the default run).

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
}
SOURCE = {
    "expert_gate_up": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/expert_gemm.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
# the kernels each served path must launch
PATH_KERNELS = {
    "serve": ("expert_gate_up", "grouped_matmul", "decode_attention", "flash_attention"),
    "serve_long": ("expert_gate_up", "grouped_matmul", "decode_attention",
                   "flash_attention"),
    "serve_ssm": ("ssd_scan",),
}
# every launch of a served (bf16, full-size) path must take these designs
NEW_DESIGNS = (("expert_gate_up", "wgmma"), ("grouped_matmul", "wgmma"),
               ("decode_attention", "split"), ("flash_attention", "wgmma"))
# the long-prompt path: 32 prompts even-spread over 1024..3584, decode 64
# (max_seq 3648, within OLMoE's 4096 context), at the planner's b_a
LONG_REQUESTS, LONG_MIN, LONG_MAX, LONG_DECODE = 32, 1024, 3584, 64
# the SSM path: 128 prompts even-spread over 200..1800 on Mamba2-370M, decode
# 64 (max_seq 1864, within its 2048-token training context)
SSM_ARCH, SSM_REQUESTS, SSM_MIN, SSM_MAX, SSM_DECODE = "mamba2-370m", 128, 200, 1800, 64


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
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


RANGES = ("ssm_decode",)     # profiler ranges whose device time is read


def profile_region(fn, top: int = 12):
    """Run ``fn`` under torch.profiler: device-busy ms (sum of kernel times
    on the one stream), the kernels that took the most device time, every
    kernel's ms (``by_kernel``, not printed) and, for each profiler range of
    ``RANGES``, the device ms of the kernels launched inside it (``ranges``,
    from the range's host-side event).  Returns (summary, fn())."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows, ranges = [], {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
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
    "ssd_scan": lambda x, *a, lengths=None, **kw: (
        x.shape[0] * x.shape[1] if lengths is None else int(lengths.long().sum())),
}


@contextlib.contextmanager
def capture_calls(names):
    """Wrap the kernel ops ``names`` so that a copy of the arguments of each
    one's largest call (by ``WORK``) is kept: the shapes and data the path
    gives the kernel.  Yields {name: (args, kwargs)}."""
    from repro_torch.kernels import ops

    best, saved = {}, {n: getattr(ops, n) for n in names}

    def copy(v):
        return v.clone() if torch.is_tensor(v) else v

    def wrap(name, fn):
        def call(*args, **kw):
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
    REL_SSD_STATE of its peak.  No single PyTorch call computes the SSD
    scan, so the library column is null."""
    from repro_torch.kernels import ops, ref

    Bt, S, nh, hp = x.shape
    ns, dtype, dev = B.shape[-1], x.dtype, x.device

    def kern():
        return ops.ssd_scan(x, B, C, dt, A, chunk, lengths=lens)

    def plain():
        return ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lens)

    (y, h), (y_ref, h_ref) = kern(), plain()
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
    live = [S] * Bt if lens is None else [int(n) for n in lens.tolist()]
    zero_rows = all(int(torch.count_nonzero(y[b, n:])) == 0 for b, n in enumerate(live))
    case = {"case": name, "B": Bt, "S": S, "nh": nh, "hp": hp, "ns": ns, "chunk": chunk,
            "lengths": None if lens is None else [min(live), max(live)],
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": y_err[0],
            "rel_err": y_err[1], "ref_peak": float(y_ref.float().abs().max()),
            "state_rel_err": state_rel, "state_peak": float(h_ref.abs().max()),
            "zero_rows_past_lengths": zero_rows, "tolerance": tol}
    if not (y_ok and state_rel < REL_SSD_STATE and zero_rows):
        emit(case)
        raise AssertionError(f"{name}: K5 y error {y_err}, state {state_rel}, "
                             f"zero rows {zero_rows} outside {tol}")
    nbytes, flops = ssd_work(Bt, S, nh, hp, ns, chunk, None if lens is None else live,
                             x.element_size())
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    big = Bt * S * nh > 1 << 20
    case.update({"ms": time_ms(kern, 5 if big else 20),
                 "plain_ms": time_ms(plain, 2 if big else 5, 1),
                 "library_ms": None,
                 "library": "none: no single PyTorch call computes the SSD scan",
                 "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                 "gbytes": nbytes / 1e9})
    emit(case)
    return {"name": "ssd_scan", "case": name, "design": "simt", "max_abs_err": y_err[0],
            "rel_err": y_err[1], "state_rel_err": state_rel, "tolerance": tol,
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


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
def serve_setup(lens, decode_len: int, arch: str = "olmoe-1b-7b"):
    """A served path on a full-size config: the planner's plan on the H100
    profile for these prompts, with b_e raised to B (one expert can take
    every token of a step, so no copy drops and both schedulers must give
    identical tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM_80GB
    from repro_torch.launch.serve import build_plan

    cfg = get_config(arch)
    n = len(lens)
    args = argparse.Namespace(prompt_lens=lens, decode_len=decode_len,
                              scheduler="static", batch=n, requests=n, b_e=n)
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


def serve_both(dev, cfg, params, plan, requests, decode_len: int, phase: str):
    """Serve ``requests`` through the port's ``Server`` under the static and
    then the continuous scheduler, the launch counts set to 0 just before
    each run and read just after.  Fails unless every request gets its
    ``decode_len`` tokens, every kernel of the path (``PATH_KERNELS``) was
    launched, no routed copy dropped, both schedulers give identical tokens
    and each deleted server frees its cache by reference counting."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving.server import ServeConfig, Server

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
        before = torch.cuda.memory_allocated()
        server = Server(cfg, params, plan,
                        serve=ServeConfig(scheduler=sched, decode_len=decode_len),
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
        emit({"phase": phase, "scheduler": sched, "wall_s": wall,
              "prefill_tokens": rep.prefill_tokens, "prefill_s": rep.prefill_s,
              "prefill_tok_s": rep.prefill_throughput,
              "decode_tokens": rep.decode_tokens, "decode_s": rep.decode_s,
              "decode_tok_s": rep.decode_throughput,
              "server_ms_per_tick": rep.decode_s * 1e3 / (rep.decode_slot_steps / plan.B),
              "dropped": rep.expert_tokens_dropped,
              "decode_slot_steps": rep.decode_slot_steps,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts[sched]})
        if dev.type == "cuda" and not all(counts[sched][k] > 0 for k in PATH_KERNELS[phase]):
            raise AssertionError(f"{sched}: a kernel of the path was never launched: "
                                 f"{counts[sched]}")
        if dev.type == "cuda" and any(counts[sched][k] != counts[sched][f"{k}_{d}"]
                                      for k, d in NEW_DESIGNS):
            raise AssertionError(f"{sched}: a K1, K2 or K4 launch of the path did not "
                                 f"take the wgmma design, or a K3 launch the split "
                                 f"design: {counts[sched]}")
        if len(rep.request_results) != n_requests or any(
                r.tokens.size != decode_len for r in rep.request_results):
            raise AssertionError(f"{sched}: wrong number of tokens served")
        if rep.expert_tokens_dropped != 0:
            raise AssertionError(f"{sched}: {rep.expert_tokens_dropped} copies dropped")
        del server
        freed(phase, f"{sched} server", before)
    for i, (a, b) in enumerate(zip(tokens["static"], tokens["continuous"])):
        if not np.array_equal(a, b):
            step = int(np.flatnonzero(a != b)[0]) if a.shape == b.shape else -1
            raise AssertionError(f"static and continuous schedulers gave different "
                                 f"tokens: request {i}, first at step {step}")
    flat = np.concatenate(tokens["static"])
    if flat.min() < 0 or flat.max() >= cfg.vocab_size:
        raise AssertionError("token ids out of range")
    return tokens, reports, counts


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
# decode_attn_kernel), then library matrix products
KERNEL_CLASSES = (("K5", ("ssd_scan_kernel",)),
                  ("K4", ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")),
                  ("K3", ("decode_split_kernel", "decode_attn_kernel")),
                  ("K1", ("gate_up_wgmma_kernel", "gemm_bf16_kernel<true>",
                          "gemm_f32_kernel<true>")),
                  ("K2", ("gemm_wgmma_kernel", "gemm_bf16_kernel<false>",
                          "gemm_f32_kernel<false>")),
                  ("library GEMM (projections, LM head, einsums)",
                   ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")))


def kernel_shares(by_kernel: dict, busy: float) -> dict:
    """Device ms and share of ``busy`` of each KERNEL_CLASSES class, and of
    the rest (elementwise glue, copies, reductions)."""
    out = {}
    for name, ms in by_kernel.items():
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                   "other (elementwise, copies, reductions)")
        out[cls] = out.get(cls, 0.0) + ms
    return {c: {"ms": ms, "share_of_busy": ms / busy} for c, ms in out.items()}


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
                 profile=False, steps: int = 4):
    """A fresh engine on a served path's prompts: one prefill wave and
    ``steps`` decode ticks (one ``decode_chunk`` tick and one token read
    each, as the server ticks) with the kernels' largest calls captured,
    the bare tick's wall, and under ``profile`` a torch.profiler breakdown
    of the ticks and of one prefill wave.  Then every captured kernel is
    held to its plain version (``check_path_kernels``)."""
    import numpy as np

    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.sampling import BatchSampler

    n = len(requests)
    tick_ms = {s: rep.decode_s * 1e3 / (rep.decode_slot_steps / plan.B)
               for s, rep in reports.items()}
    eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq, device=dev)
    lengths = np.array([len(r.prompt) for r in requests], np.int64)
    prompts = np.zeros((n, int(lengths.max())), np.int64)
    for i, r in enumerate(requests):
        prompts[i, :lengths[i]] = r.prompt
    sampler = BatchSampler.uniform(n, None)
    with capture_calls(PREFILL_CAPTURE[phase]) as pre:
        lg = eng.prefill(prompts, lengths=lengths)
    tok0 = sampler.sample(lg)

    def decode_ticks():
        tok = tok0
        for t in range(steps):
            tok = eng.decode_chunk(tok, lengths + t, sampler, 1)[:, 0]
            tok.cpu()
        return tok

    with capture_calls(DECODE_CAPTURE[phase]) as dec:
        decode_ticks()                                      # warm
    wall = host_ms(decode_ticks) / steps
    lg2 = eng.decode_step(tok0, lengths)
    if not (torch.isfinite(lg).all() and torch.isfinite(lg2).all()):
        raise AssertionError(f"{phase}: non-finite logits")
    emit({"phase": phase, "what": "decode_tick", "B": n,
          "positions": [int(lengths.min()), int(lengths.max())],
          "wall_ms_per_tick": wall, "server_ms_per_tick": tick_ms})
    if profile:
        # device busy from the profiler; walls from unprofiled runs
        with ssm_decode_range():
            prof, _ = profile_region(decode_ticks)
        busy = prof["device_busy_ms"] / steps
        per_tick = {c: {"ms": v["ms"] / steps, "share_of_busy": v["share_of_busy"]}
                    for c, v in kernel_shares(prof["by_kernel"], prof["device_busy_ms"]).items()}
        emit({"phase": "profile", "what": f"{phase} decode tick B={n}, per tick",
              "wall_ms": wall, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall,
              "idle_share_vs_server": {s: 1.0 - busy / ms for s, ms in tick_ms.items()},
              "by_class": per_tick,
              "ranges_ms_per_tick": {k: v / steps for k, v in prof["ranges"].items()},
              "sync_sites": sync_sites(decode_ticks),
              "top_over_steps": prof["top"]})
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
    return counts["static"], reports


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


def kernels_line(rows, launches) -> list:
    """One entry per kernel, at the shape of the path it serves most: K1-K3
    the short serve path, K4 the long one, K5 the SSM one; "launches" is
    that path's count (from its static run), "launches_by_path" every
    path's."""
    home = {"flash_attention": "serve_long", "ssd_scan": "serve_ssm"}
    seen, line_rows = set(), []
    for r in rows:
        if r["name"] in seen:
            continue
        seen.add(r["name"])
        by_path = {k: c[r["name"]] for k, c in launches.items()}
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
    return line_rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,serve,serve_long,serve_ssm,parity")
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
    # cuBLAS keeps one workspace per handle and stream for the process, and
    # K3's split design one buffer of tickets per device: make both before
    # any server is built, so that freeing a server is exact
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones((8, 8), dtype=dt, device=dev)
        torch.addmm(a[0], a, a) @ a
        torch.bmm(a[None], a[None])
    from repro_torch.kernels import ops

    z = torch.zeros((1, 1, 1, 128), dtype=torch.bfloat16, device=dev)
    ops.decode_attention(z[:, 0], z, z, 0)
    torch.cuda.synchronize()
    if "kernels" in phases:
        _, plan, lens, decode_len = serve_setup(short_lengths(), 32)
        long_plan = serve_setup(long_lengths(), LONG_DECODE)[1]
        ssm_plan = serve_setup(ssm_lengths(), SSM_DECODE, SSM_ARCH)[1]
        rows = phase_kernels(dev, plan, span=max(lens) + decode_len,
                             prompt_len=max(lens), long_b_a=long_plan.b_a,
                             ssm_b_a=ssm_plan.b_a)
        emit({"kernel_cases": rows})
    launches = {}                           # per path: counts from its static run
    if phases & {"serve", "serve_long"}:
        params = init_weights(dev)
        if "serve" in phases:
            launches["serve"], _ = phase_serve(dev, params,
                                               profile="profile" in phases)
        if "serve_long" in phases:
            launches["serve_long"], _ = phase_serve_long(dev, params,
                                                         profile="profile" in phases)
        del params
        torch.cuda.empty_cache()
    if "serve_ssm" in phases:
        launches["serve_ssm"], _ = phase_serve_ssm(dev, profile="profile" in phases)
    if "parity" in phases:
        phase_parity(dev)
    line_rows = kernels_line(rows, launches)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if line_rows:
        emit({"kernels": line_rows})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
