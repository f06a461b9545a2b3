"""Rank bodies for ``tests/test_torch_sharded_model.py``.

Each function runs in a process that ``repro_torch.launch.mesh.spawn``
starts, joined to a gloo group, on the CPU.  This module imports the port
only (no JAX), so a rank starts quickly; the test process holds the results
against the JAX package.  Every input arrives as numpy (the JAX weights
bridged by ``repro_torch.bridge.from_numpy_params``), every result leaves
as numpy.
"""
from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _ctx(dims, seq_shard: bool, dispatch: str = "psum"):
    from repro_torch.launch import mesh

    return replace(mesh.make_ctx(mesh.make_debug_mesh(*dims), seq_shard=seq_shard),
                   moe_dispatch=dispatch)


def _local(cfg, np_params, ctx):
    from repro_torch.bridge import from_numpy_params
    from repro_torch.sharding.specs import shard_params

    return shard_params(ctx, cfg, from_numpy_params(cfg, np_params, "cpu"))


def forward_case(cfg, np_params, tokens, ctx):
    """``forward``'s logits and aux for this rank's rows."""
    from repro_torch.models import model as M

    params = _local(cfg, np_params, ctx)
    toks = M.rows_of(ctx, torch.from_numpy(tokens).long())
    with torch.no_grad():
        logits, aux, _ = M.forward(cfg, params, toks, ctx=ctx)
    return {"logits": _np(logits), "aux": float(aux)}


def loss_case(cfg, np_params, tokens, labels, ctx):
    """``loss_fn`` (remat on) and every leaf's gradient, summed over the
    batch axes and gathered whole (rank 0 returns them)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import gather_params, tree_paths
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    params = _local(cfg, np_params, ctx)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    total, (nll, aux) = M.loss_fn(cfg, params, M.rows_of(ctx, torch.from_numpy(tokens).long()),
                                  M.rows_of(ctx, torch.from_numpy(labels).long()), ctx=ctx)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [C.all_reduce_value(torch.zeros_like(p) if g is None else g, ctx.batch_group)
             for p, g in zip(leaves, grads)]
    full = gather_params(ctx, cfg, tree_unflatten(params, grads))
    out = {"loss": float(total.detach()), "nll": float(nll.detach()), "aux": float(aux.detach())}
    if ctx.model_rank == ctx.batch_rank == 0:
        out["grads"] = {path: _np(g) for path, g in tree_paths(full)}
    return out


def moe_case(cfg, np_moe, x, dispatch: str, want_grads: bool, ctx):
    """One MoE layer on this rank's rows of ``x`` (B, S, D) in the
    residual's layout: the psum capacity path (no small-batch return) or
    a2a; the output gathered back to the rows' whole sequences, aux, and
    with ``want_grads`` the gradients of ``sum(y * x)`` for ``x`` (this
    rank's rows) and every weight (summed over the batch axes, gathered)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.bridge import to_tensor
    from repro_torch.sharding.specs import gather_params, shard_params

    S = x.shape[1]
    c = replace(ctx, moe_dispatch=dispatch).for_sequence(S)
    tree = {"layers": [{"moe": {n: to_tensor(a) for n, a in np_moe.items()}}]}
    p = shard_params(c, cfg, tree)["layers"][0]["moe"]
    xl = M.rows_of(c, torch.from_numpy(x)).clone().requires_grad_(want_grads)
    with torch.set_grad_enabled(want_grads):
        for t in p.values():
            t.requires_grad_(want_grads)
        xr = C.residual_rows(c, xl)
        if dispatch == "a2a":
            y, aux = moe.moe_apply_a2a(cfg, p, xr, c)
        else:
            y, aux = moe.moe_apply_sharded(cfg, p, xr, c, small_batch_threshold=0)
        y = C.whole_sequence(c, y)
    out = {"y": _np(y), "aux": float(aux)}
    if want_grads:
        # every rank holds its rows' whole y: each rank's term is its own
        names = list(p)
        gs = torch.autograd.grad((y * xl).sum(), [xl] + [p[n] for n in names])
        out["dx"] = _np(gs[0])
        ws = {n: C.all_reduce_value(g, c.batch_group) for n, g in zip(names, gs[1:])}
        full = gather_params(c, cfg, {"layers": [{"moe": ws}]})["layers"][0]["moe"]
        out["dw"] = {n: _np(t) for n, t in full.items()}
    return out


def zero1_case(cfg, np_params, np_grads, lr: float, ctx):
    """One ZeRO-1 AdamW step: this rank's shares of the whole gradients,
    each divided by the data-parallel degree (the sum over the batch axes is
    the whole gradient again, exactly); the updated parameters gathered
    whole (rank 0 returns them) and the norm."""
    from repro_torch.bridge import from_numpy_params
    from repro_torch.sharding.specs import gather_params, shard_params, tree_paths
    from repro_torch.train.optimizer import adamw_init, adamw_update, tree_leaves, tree_map

    params = _local(cfg, np_params, ctx)
    grads = shard_params(ctx, cfg, from_numpy_params(cfg, np_grads, "cpu"))
    grads = tree_map(lambda g: g / ctx.batch_size, grads)
    opt = adamw_init(params, ctx, cfg)
    params, opt, gnorm = adamw_update(params, grads, opt, lr=lr, ctx=ctx, cfg=cfg)
    full = gather_params(ctx, cfg, params)
    out = {"gnorm": float(gnorm), "step": int(opt.step),
           "moment_elems": sum(t.numel() for t in tree_leaves(opt.mu))}
    if ctx.model_rank == ctx.batch_rank == 0:
        out["params"] = {path: _np(t) for path, t in tree_paths(full)}
    return out


def decode_case(cfg, np_params, tokens, ctx):
    """``decode_step`` from a zeroed cache (``init_cache(ctx)``: this rank's
    share), one step per column of ``tokens``: each step's logits for this
    rank's rows."""
    from repro_torch.models import model as M

    params = _local(cfg, np_params, ctx)
    toks = M.rows_of(ctx, torch.from_numpy(tokens).long())
    cache = M.init_cache(cfg, toks.shape[0], toks.shape[1], device="cpu", ctx=ctx)
    out = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = M.decode_step(cfg, params, cache, toks[:, t], t, ctx=ctx)
            out.append(_np(logits))
    return np.stack(out, axis=1)


def generate_case(cfg, np_params, tokens, decode_len: int, ctx):
    """``greedy_generate(ctx)`` on this rank's rows."""
    from repro_torch.models import model as M
    from repro_torch.serving.generate import greedy_generate

    params = _local(cfg, np_params, ctx)
    with torch.no_grad():
        out = greedy_generate(cfg, params, M.rows_of(ctx, torch.from_numpy(tokens).long()),
                              decode_len, ctx=ctx)
    return _np(out)


def mesh_rank(rank: int, n: int, group, plan):
    """Run ``plan``: a list of (mesh dims, seq_shard, [(name, case function
    name, args)]) on this world of ``n`` ranks, building each mesh in turn
    over all of them.  Returns {name: result}."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    cases = {"forward": forward_case, "loss": loss_case, "moe": moe_case,
             "zero1": zero1_case, "decode": decode_case, "generate": generate_case}
    out = {}
    for dims, seq_shard, items in plan:
        ctx = _ctx(dims, seq_shard)
        for name, fn, args in items:
            out[name] = cases[fn](*args, ctx)
        out[f"coords{dims}"] = (ctx.batch_rank, ctx.model_rank)
    return out


def cuda_sharded_rank(rank: int, n: int, group, layers: int, B: int, S: int):
    """``tests/test_torch_cuda.py``'s rank on the card: full-width OLMoE at
    ``layers`` layers, bf16, on a (1, n) mesh with ``seq_shard``: a prefill's
    launch counts and local kernel shapes, then ``loss_fn``'s gradient on
    every leaf (its largest magnitude and whether it is finite)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import shard_params, tree_paths
    from repro_torch.train.optimizer import tree_leaves

    dev = torch.device("cuda")
    cfg = replace(get_config("olmoe-1b-7b"), num_layers=layers)
    ctx = _ctx((1, n), True)
    params = shard_params(ctx, cfg, M.init_params(cfg, seed=0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    shapes = {}
    wrapped = {name: getattr(ops, name) for name in
               ("flash_attention", "grouped_expert_ffn")}

    def keep(name):
        def call(*a, **kw):
            shapes.setdefault(name, tuple(a[0].shape))
            return wrapped[name](*a, **kw)
        return call

    ops.reset_launch_counts()
    for name in wrapped:
        setattr(ops, name, keep(name))
    try:
        with torch.no_grad():
            logits, _ = M.prefill(cfg, params, toks, ctx=ctx)
        torch.cuda.synchronize()
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    counts = ops.launch_counts()
    for t in tree_leaves(params):
        t.requires_grad_(True)
    total, _ = M.loss_fn(cfg, params, toks, torch.roll(toks, -1, 1), ctx=ctx)
    grads = torch.autograd.grad(total, tree_leaves(params))
    return {"counts": counts, "shapes": shapes, "finite_logits": bool(logits.isfinite().all()),
            "loss": float(total), "after_grad": ops.launch_counts(),
            "grads": {path: (float(g.float().abs().max()), bool(g.isfinite().all()))
                      for (path, _), g in zip(tree_paths(params), grads)}}
