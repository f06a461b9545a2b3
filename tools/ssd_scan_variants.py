"""Where K5's time goes: the mma design with one part removed or changed.

    python3 tools/ssd_scan_variants.py

Needs one CUDA card and nvcc.  Each variant is a copy of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` with a few lines replaced
(``VARIANTS``); all are built in parallel into ``build/ssd_scan_variants/``
and timed by CUDA events, twice in turns, at the serve_ssm micro-batch of
``chip_smoke.py`` (B32 S1800, nh 32, hp 64, ns 128, chunk 256, lengths
1409..1800, the same seeded inputs).  Each line gives the variant's
registers, its two times, and its y and state errors against the plain
version: a variant that removes work is not a correct kernel, only a
measure of what that work costs.  The last line is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "ssd_scan.cu")
OUT = os.path.join(ROOT, "build", "ssd_scan_variants")

# name -> [(text of the source, its replacement)]
VARIANTS = {
    "mma": [],
    # the y phase or the state update left out
    "no_y_phase": [("      if (t < QT)\n", "      if (false)\n")],
    "no_state_update": [("    if (s_warp) {\n      const float decay",
                         "    if (false) {\n      const float decay")],
    # one bf16 term instead of hi + lo, for each f32 operand
    "m_hi_only": [("      mma_bf16(acc[2 * n2], ml, bb[0], bb[1]);\n"
                   "      mma_bf16(acc[2 * n2 + 1], ml, bb[2], bb[3]);\n", "")],
    "h_hi_only": [("        ldmatrix_x4_trans(bl, Hl + SH::at(16 * ks + a_r, 16 * n2 + a_c));\n", ""),
                  ("        mma_bf16(acc[2 * n2], ca[ks], bl[0], bl[1]);\n"
                   "        mma_bf16(acc[2 * n2 + 1], ca[ks], bl[2], bl[3]);\n", "")],
    "wx_hi_only": [("            mma_bf16(hacc[m][n], af, bl[n][0], bl[n][1]);\n", "")],
    # M's elementwise work (f64 differences, exp, dt, mask) left out
    "no_m_elementwise": [
        ("split_bf16(cb[n][0] * expf(l00) * d0, cb[n][1] * expf(l01) * d1,",
         "split_bf16(cb[n][0], cb[n][1],"),
        ("split_bf16(cb[n][2] * expf(l10) * d0, cb[n][3] * expf(l11) * d1,",
         "split_bf16(cb[n][2], cb[n][3],")],
    # one chain of C B^T accumulators instead of two
    "one_cb_chain": [("      float(*dst)[4] = (ks & 1) ? cb_odd : cb;", "      float(*dst)[4] = cb;")],
    # B of the next chunk not loaded (its exposed load)
    "no_b_reload": [("      stage_rows<NS>(Bs, Bb, NS, c0 + Q, Q, len, tid);\n      stage_dt",
                     "      stage_dt")],
}


def build():
    """Compile every variant (one nvcc each, all at once); returns
    {name: (the C entry point, registers of the serve-shape kernel)}."""
    import chip_smoke as cs
    from repro_torch.kernels import build as kb

    src = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(OUT, f"lib{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")).repro_ssd_scan_mma
        fn.argtypes = kb._ARGTYPES["repro_ssd_scan_mma"]
        fn.restype = ctypes.c_int
        regs = next(r[1] for r in cs.ptxas_summary(log)
                    if r[0] == "ssd_mma_kernel<128,64,bf16>")
        libs[name] = (fn, regs)
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("ssd_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    Bt, S, nh, hp, ns, Q = 32, cs.SSM_MAX, 32, 64, 128, 256
    x, B, C, dt, A = cs.ssd_inputs(gen, Bt, S, nh, hp, ns, torch.bfloat16, dev)
    lens = torch.tensor(cs.ssm_lengths()[-Bt:], device=dev, dtype=torch.int32)
    y_ref, h_ref = ref.ssd_scan_ref(x, B, C, dt, A, Q, lengths=lens)
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    h = torch.empty((Bt, nh, ns, hp), dtype=torch.float32, device=dev)

    def launcher(fn):
        def go():
            err = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     lens.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S, nh, hp, ns, Q, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return go

    rows = {}
    for turn in range(2):
        for name, (fn, regs) in libs.items():
            go = launcher(fn)
            ms = cs.time_ms(go, 10)
            row = rows.setdefault(name, {"registers": regs, "ms": []})
            row["ms"].append(ms)
            if turn == 0:
                go()
                torch.cuda.synchronize()
                d = (h - h_ref).abs().amax((-2, -1)) / h_ref.abs().amax((-2, -1))
                row.update({"y_rel_err": cs.errors(y, y_ref)[1],
                            "state_rel_err": float(d.max())})
    for name, row in rows.items():
        print(json.dumps({"variant": name, **row}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
