"""The port's counterpart of ``repro.launch.roofline``: a roofline per
(arch x shape) on the single-pod mesh from the dry run's reports
(``launch.dryrun``, ``reports/dryrun_torch/``), reckoned with an NVIDIA
H100's datasheet peaks:

  compute term    = dot_FLOPs_per_rank       / peak_FLOP/s
  memory term     = HBM_bytes_per_rank       / HBM_bw
  collective term = collective_bytes_per_rank / link_bw

The dot FLOPs and collective bytes are the dry run's trace of one rank's
step (``launch.trace_analysis``: the plain versions' FLOPs, the port's own
exchanges).  HBM traffic is the reference's analytic model (weights
streamed per pass, cache reads, residual activations), copied unchanged.
These are reckoned figures, never measured ones.

Usage:
    python -m repro_torch.launch.roofline [--write reports/roofline_torch.md]
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import workload as W

# NVIDIA H100 SXM5 80GB at its 700 W limit, from NVIDIA's H100 datasheet:
# 989.4 TFLOP/s bf16 dense tensor-core math, 3.35 TB/s HBM3.
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
# The collective link: one 400 Gb/s NDR InfiniBand adapter per GPU (50 GB/s).
# Each 16-rank axis of the production mesh spans two 8-GPU NVLink nodes, so
# the inter-node link sets the pace; an axis that fits in one node would run
# at NVLink 4's 450 GB/s per direction.
LINK_BW = 50e9
CARD = "NVIDIA H100 SXM5 80GB, 700 W"
DEVICE_GB = 80.0                  # the card's memory, GB (1e9 bytes)
REPORT_DIR = os.path.join(os.path.dirname(__file__), "../../../reports/dryrun_torch")

N_DEV_SINGLE = 256
MODEL_PAR = 16
DATA_PAR = 16


# ---------------------------------------------------------------------------
# Analytic HBM traffic per device per step
# ---------------------------------------------------------------------------
def memory_bytes_per_device(cfg: ModelConfig, shape: ShapeSpec,
                            weights: str = "fsdp") -> Dict[str, float]:
    """Per-device HBM bytes for one step (components + total)."""
    n_dev = N_DEV_SINGLE
    model_b = W.model_bytes(cfg)
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(1, B // DATA_PAR)

    if shape.kind == "train":
        # fwd + remat-fwd + bwd weight reads; FSDP gathers write once more.
        w_passes = 4.0 if weights == "fsdp" else 3.0
        w_bytes = model_b * w_passes / (MODEL_PAR if weights == "tp" else 1)
        # optimizer state read+write (f32 m, v) + grads, fully sharded
        opt_bytes = cfg.param_counts()["total"] * (4 + 4 + 4) * 2 / n_dev
        act = 12 * cfg.num_layers * b_loc * S * cfg.d_model * 2 / MODEL_PAR
        total = w_bytes + opt_bytes + act
        return {"weights": w_bytes, "opt": opt_bytes, "act": act,
                "total": total}

    if shape.kind == "prefill":
        w_bytes = model_b / (MODEL_PAR if weights == "tp" else 1)
        act = 12 * cfg.num_layers * b_loc * S * cfg.d_model * 2 / MODEL_PAR
        kv_w = b_loc * W.kv_bytes_per_seq(cfg, S) / MODEL_PAR * DATA_PAR / DATA_PAR
        total = w_bytes + act + kv_w
        return {"weights": w_bytes, "act": act, "kv": kv_w, "total": total}

    # decode: one token; weights + full cache read dominate
    w_bytes = model_b / (MODEL_PAR if weights == "tp" else 1)
    kv = B * W.kv_bytes_per_seq(cfg, S) / n_dev * DATA_PAR  # sharded B/data, heads/model
    act = 8 * cfg.num_layers * b_loc * cfg.d_model * 2
    total = w_bytes + kv + act
    return {"weights": w_bytes, "kv": kv, "act": act, "total": total}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.param_counts()["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


# ---------------------------------------------------------------------------
# Assemble the table
# ---------------------------------------------------------------------------
@dataclass
class RooflineRow:
    arch: str
    shape: str
    status: str
    compute_s: Optional[float] = None
    memory_s: Optional[float] = None
    collective_s: Optional[float] = None
    dominant: str = ""
    model_flops: float = 0.0
    dot_flops_global: float = 0.0
    useful_ratio: Optional[float] = None
    note: str = ""
    peak_bytes: Optional[float] = None    # the rank's step peak (dry run)


LEVERS = {
    "compute": "cut implementation FLOP waste (causal block skipping / "
               "lower capacity factor / no remat recompute)",
    "memory": "keep weights resident (TP instead of FSDP) or batch more "
              "tokens per weight read — the paper's module-batching insight",
    "collective": "reshard: fewer all-gathers (weight-stationary), bf16 "
                  "collectives, or all-to-all expert dispatch",
}


def load_report(arch: str, shape: str, mesh: str = "single",
                weights: str = "fsdp", report_dir: Optional[str] = None) -> Optional[dict]:
    path = os.path.join(report_dir or REPORT_DIR, f"{arch}_{shape}_{mesh}_{weights}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def build_rows(weights: str = "fsdp", report_dir: Optional[str] = None) -> List[RooflineRow]:
    rows = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            rep = load_report(arch, shape_name, "single", weights, report_dir)
            if rep is None:
                rows.append(RooflineRow(arch, shape_name, "missing"))
                continue
            if rep["status"] == "skipped":
                rows.append(RooflineRow(arch, shape_name, "skipped",
                                        note=rep["reason"]))
                continue
            if rep["status"] != "ok":
                rows.append(RooflineRow(arch, shape_name, "failed",
                                        note=rep.get("error", "")[:80]))
                continue
            dot = rep.get("dot_flops_per_device") or 0.0
            coll = rep.get("collective_bytes") or 0.0
            mem = memory_bytes_per_device(cfg, shape, weights)
            c_t = dot / PEAK_FLOPS
            m_t = mem["total"] / HBM_BW
            i_t = coll / LINK_BW
            terms = {"compute": c_t, "memory": m_t, "collective": i_t}
            dom = max(terms, key=terms.get)
            mf = model_flops(cfg, shape)
            dot_global = dot * N_DEV_SINGLE
            rows.append(RooflineRow(
                arch, shape_name, "ok", c_t, m_t, i_t, dom, mf, dot_global,
                (mf / dot_global) if dot_global else None,
                LEVERS[dom], (rep.get("memory") or {}).get("peak_size_in_bytes"),
            ))
    return rows


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1.0:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def to_markdown(rows: List[RooflineRow], weights: str) -> str:
    out = [
        f"### Roofline — single pod (16x16 = 256 ranks, weights={weights}), reckoned "
        f"from datasheet peaks, {CARD}",
        "",
        "| arch | shape | compute | memory | collective | bottleneck | "
        f"MODEL_FLOPS | useful% | peak/rank of {DEVICE_GB:.0f} GB | lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.status != "ok":
            out.append(
                f"| {r.arch} | {r.shape} | — | — | — | {r.status} | — | — | — | "
                f"{r.note[:70]} |"
            )
            continue
        useful = f"{100*r.useful_ratio:.0f}%" if r.useful_ratio else "-"
        peak = "-" if r.peak_bytes is None else f"{r.peak_bytes / 1e9:.1f} GB"
        out.append(
            f"| {r.arch} | {r.shape} | {fmt_s(r.compute_s)} | "
            f"{fmt_s(r.memory_s)} | {fmt_s(r.collective_s)} | "
            f"**{r.dominant}** | {r.model_flops:.2e} | "
            f"{useful} | {peak} | {r.note[:70]} |"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="fsdp")
    ap.add_argument("--write", default=None)
    args = ap.parse_args(argv)
    rows = build_rows(args.weights)
    md = to_markdown(rows, args.weights)
    print(md)
    if args.write:
        os.makedirs(os.path.dirname(args.write) or ".", exist_ok=True)
        with open(args.write, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
