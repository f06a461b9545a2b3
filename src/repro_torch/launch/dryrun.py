"""The port's counterpart of ``repro.launch.dryrun``: does one rank's step
of every (architecture x input shape x production mesh) run, and what does
it hold, compute and exchange?

The reference compiles each step for 256 or 512 forced host devices and
reads the compiled module's memory and cost analysis.  Here each case runs
ONE rank (rank 0) of the production mesh in this process:

* a fake process group of 256 (single pod, data 16 x model 16) or 512
  (multi-pod, pod 2 x data 16 x model 16) ranks (``launch.mesh.fake_group``:
  PyTorch's fake backend, whose collectives return at once) and
  ``launch.mesh.make_mesh`` over it;
* every tensor a fake CPU tensor (``FakeTensorMode``): shapes, dtypes and
  storages without memory, so nothing is allocated and nothing is launched
  on any device.  This is the counterpart of the reference compiling for
  forced host devices, not a fallback: the kernel ops take their plain
  versions (``kernels/ref.py``) because the tensors are CPU tensors;
* the rank's own step, as the port runs it: ``make_train_step(remat=True)``
  with AdamW, ``models.model.prefill`` or one ``decode_step`` against a
  cache of ``seq_len`` (the rank's share, ``specs.cache_placement``), under
  ``trace_analysis.Recorder``.  ``weights="fsdp"`` places the parameters
  as the reference's ``param_shardings(zero1=True)`` does (each leaf also
  split over the batch axes, gathered where a layer starts; the optimizer
  state likewise), ``"tp"`` over the model axis only.  Building them is
  counted apart (``build_peak_size_in_bytes``): each weight is drawn whole
  and cut to the rank's share at once, and the cache is allocated at the
  share's shape.

What the counts mean: the FLOPs are the plain versions' (attention over
the full S x S scores, as in the reference's XLA math; the router's
products padded to 1024-row blocks); the temporaries are the plain
versions' chunking (about 256 MB of attention scores, about 1 GB of SSD
rows), upper bounds on the kernels' own; the collectives are the port's
real exchanges (every sum in f32, a reduce-scatter as an all-reduce and a
share, since gloo has none).

Reports go to ``reports/dryrun_torch/<arch>_<shape>_<mesh>_<weights>.json``
(never ``reports/dryrun/``, which holds the reference's TPU reports) with
the op and collective trace beside each (``.trace.jsonl.gz``).

Usage:
    python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--weights fsdp|tp]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import fake_group, make_ctx, make_mesh, make_production_mesh
from repro_torch.sharding.specs import leaf_shapes

REPORT_DIR = os.path.join(os.path.dirname(__file__), "../../../reports/dryrun_torch")

NOTE = ("one rank of the mesh on fake CPU tensors: FLOPs and temporaries are the plain "
        "versions' (full S x S attention scores, router products padded to 1024-row "
        "blocks, ~256 MB attention-score and ~1 GB SSD chunks), upper bounds on the "
        "kernels'; collectives are the port's own (f32 sums, reduce-scatter as all-reduce "
        "plus a share)")


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (see DESIGN.md §4)"
        )
    return None


@contextlib.contextmanager
def rank_of(dims: Sequence[int], names: Sequence[str]):
    """Rank 0 of a mesh of ``dims`` over a fake group: yields the mesh; the
    group is destroyed on exit."""
    n = 1
    for d in dims:
        n *= d
    with fake_group(n):
        yield make_mesh(dims, names)


def _rows(ctx, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``t``, in a storage of their own."""
    from repro_torch.models.model import rows_of

    return rows_of(ctx, t).clone()


def build_case(cfg: ModelConfig, shape: ShapeSpec, ctx, weights: str = "fsdp"):
    """This rank's step and its arguments: fake tensors when called inside
    ``FakeTensorMode`` (the dry run), else real CPU tensors (seeded weights,
    zero tokens).  Returns ``(fn, args, layers)``: ``fn()`` runs the step;
    ``args`` is every tensor the rank holds before it (parameters,
    optimizer state, cache, its rows of the inputs)."""
    from repro_torch.models import model as M
    from repro_torch.models.frontends import frontend_spec
    from repro_torch.train.optimizer import adamw_init, tree_leaves
    from repro_torch.train.train_loop import make_train_step

    zero1 = weights == "fsdp"
    B, S = shape.global_batch, shape.seq_len
    local = M.init_params(cfg, device="cpu", ctx=ctx, zero1=zero1)
    spec = frontend_spec(cfg, B)
    fe = None if spec is None else _rows(ctx, torch.empty(spec.shape, dtype=spec.dtype))
    tokens = _rows(ctx, torch.zeros((B, S if shape.kind != "decode" else 1),
                                    dtype=torch.long))

    if shape.kind == "train":
        for p in tree_leaves(local):
            p.requires_grad_(True)
        opt = adamw_init(local)
        labels = torch.zeros_like(tokens)
        step = make_train_step(cfg, remat=True, ctx=ctx)
        args = {"params": local, "opt": opt, "tokens": tokens, "labels": labels, "fe": fe}
        return (lambda: step(local, opt, tokens, labels, fe)), args, cfg.num_layers

    if shape.kind == "prefill":
        def prefill_step():
            with torch.no_grad():
                return M.prefill(cfg, local, tokens, fe, ctx=ctx)

        return prefill_step, {"params": local, "tokens": tokens, "fe": fe}, cfg.num_layers

    # decode: ONE new token for each of this rank's rows against a cache of seq_len
    cache = M.init_cache(cfg, tokens.shape[0], S, device="cpu", ctx=ctx)
    toks = tokens[:, 0].contiguous()

    def serve_step():
        with torch.no_grad():
            return M.decode_step(cfg, local, cache, toks, S - 1, ctx=ctx)

    return serve_step, {"params": local, "cache": cache, "tokens": toks}, cfg.num_layers


def run_case(arch: str, shape_name: str, multi_pod: bool, weights: str = "fsdp",
             save: bool = True, seq_shard: Optional[bool] = None,
             mesh_dims: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeSpec] = None,
             trace: bool = True) -> dict:
    """One case: rank 0 of the production mesh (or of ``mesh_dims``, a
    (dims, names) pair) runs its step on fake tensors.  ``cfg``/``shape``
    replace the named ones (smaller cases, tests).  The report, and with
    ``save`` its file; ``out["trace"]`` holds the records when ``save`` is
    off and ``trace`` on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "weights": weights,
           "status": "ok"}
    reason = skip_reason(cfg, shape)
    if reason:
        out["status"] = "skipped"
        out["reason"] = reason
        return _save(out) if save else out
    if mesh_dims is None:
        prod = make_production_mesh(multi_pod=multi_pod)
        mesh_dims = (prod.dims, prod.axis_names)
    if seq_shard is None:
        seq_shard = shape.kind == "train"
    out["seq_shard"] = seq_shard
    out["mesh_dims"] = dict(zip(mesh_dims[1], mesh_dims[0]))
    t0 = time.time()
    try:
        with rank_of(*mesh_dims) as mesh, FakeTensorMode():
            ctx = make_ctx(mesh, seq_shard=seq_shard)
            if shape.global_batch % ctx.batch_size:
                # the reference's spec drops a split the batch does not divide:
                # every data rank holds the whole batch
                ctx = replace(ctx, batch_axes=())
                out["batch_replicated"] = True
            leaf_shapes(cfg)        # its fake whole tree is analysis, not the rank's
            with trace_analysis.Recorder(mesh) as build:
                fn, args, layers = build_case(cfg, shape, ctx, weights)
            rec = trace_analysis.Recorder(mesh)
            rec.hold(args)
            arg_bytes = rec.live_bytes
            t1 = time.time()
            with rec:
                result = fn()
            trace_s = time.time() - t1
            out_bytes = trace_analysis.storage_bytes(result)
            peak = rec.peak_bytes
            del fn, args, result
        records = rec.records
        out.update(
            trace_s=round(trace_s, 2),
            setup_s=round(t1 - t0, 2),
            n_devices=mesh.size,
            memory={
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": peak - arg_bytes,
                "peak_size_in_bytes": peak,
                "build_peak_size_in_bytes": build.peak_bytes,
            },
            flops=trace_analysis.total_flops(records),
            dot_flops_per_device=trace_analysis.dot_flops(records),
            collectives=trace_analysis.collective_stats(records),
            collective_bytes=trace_analysis.total_collective_bytes(records),
            ops=sum(1 for r in records if r["type"] == "op"),
            layers=layers,
            note=NOTE,
        )
        if save and trace:
            _save_trace(out, records)
        elif trace:
            out["trace"] = records
    except Exception as e:  # noqa: BLE001 -- a failure here is a finding
        out["status"] = "failed"
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
    return _save(out) if save else out


def _name(out: dict) -> str:
    default_sp = out.get("shape") == "train_4k"
    suffix = ""
    if out.get("seq_shard") is not None and out["seq_shard"] != default_sp:
        suffix = "_sp" if out["seq_shard"] else "_nosp"
    return f"{out['arch']}_{out['shape']}_{out['mesh']}_{out['weights']}{suffix}"


def _save(out: dict) -> dict:
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, _name(out) + ".json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    return out


def _save_trace(out: dict, records) -> None:
    os.makedirs(REPORT_DIR, exist_ok=True)
    trace_analysis.write_trace(os.path.join(REPORT_DIR, _name(out) + ".trace.jsonl.gz"),
                               records)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--weights", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                fname = os.path.join(REPORT_DIR,
                                     f"{arch}_{shape}_{mesh_name}_{args.weights}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip existing] {arch} {shape} {mesh_name}")
                    continue
                r = run_case(arch, shape, multi, args.weights)
                mem = (r.get("memory") or {}).get("temp_size_in_bytes")
                print(
                    f"[{r['status']:7s}] {arch:24s} {shape:12s} {mesh_name:6s}"
                    f" trace={r.get('trace_s', '-'):>6}s"
                    f" temp={mem if mem is not None else '-'}"
                    f" {r.get('error', r.get('reason', ''))[:90]}", flush=True
                )


if __name__ == "__main__":
    main()
