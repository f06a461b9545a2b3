"""AdamW on the port's parameter trees (dicts and lists of tensors), with the
reference's arithmetic in the reference's order: the global f32 gradient
norm, one clip scale, the bias corrections, then ``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` in f32, cast back to ``p``'s dtype.
(``torch.optim.AdamW`` decays the weights before the step and folds the
corrections into the step size, which rounds differently.)  The update is
in place, a leaf at a time.  Nothing is read back to the host: the step
count and the norm stay device tensors.

On a mesh (``ctx``, ``cfg``; the parameters are this rank's shares,
``sharding.specs.shard_params``) the update is ZeRO-1: the gradients are
summed over the batch axes; the global norm counts each model-split share
once per rank and each whole leaf once; each leaf's moments and update
cover only this rank's slice of its ZeRO-1 dim (``specs.zero1_dim``), and
the updated slices are all-gathered over the batch axes.  ``zero1=False``
keeps every leaf's state whole on every rank (the reference's
``weights="tp"``: no ``"batch"`` dim in the optimizer's specs)."""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, on the parameters' device
    mu: object               # f32 first moments, the parameters' tree
    nu: object               # f32 second moments


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of dicts and lists, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adamw_init(params, ctx=None, cfg=None, zero1: bool = True) -> AdamWState:
    """Zero moments in f32; on a mesh (``ctx``, ``cfg``) each leaf's cover
    this rank's slice of its ZeRO-1 dim (``zero1``)."""
    dev = tree_leaves(params)[0].device
    if ctx is not None and ctx.on_mesh:
        dims = _zero1_dims(ctx, cfg, params, zero1)
        it = iter(dims)

        def zero(p):
            z = next(it)
            shape = list(p.shape)
            if z is not None:
                shape[z] //= ctx.batch_size
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        mu = tree_map(zero, params)
        it = iter(dims)
        nu = tree_map(zero, params)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), mu, nu)
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                                   device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


def _zero1_dims(ctx, cfg, params, zero1: bool = True) -> List:
    from repro_torch.sharding.specs import tree_paths, zero1_dim

    return [zero1_dim(ctx, cfg, path, tuple(p.shape)) if zero1 else None
            for path, p in tree_paths(params)]


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    ctx=None,
    cfg=None,
    zero1: bool = True,
) -> Tuple[object, AdamWState, torch.Tensor]:
    """One step, IN PLACE: every parameter and both moments are written one
    leaf at a time (no second copy of the optimizer state is ever held).
    Returns (params, the new state, gnorm), the same parameter and moment
    tensors.  On a mesh (``ctx``, ``cfg``): ZeRO-1 (``_adamw_zero1``; with
    ``zero1=False`` each leaf's state whole), with ``grads`` this rank's
    (summed over the batch axes here)."""
    if ctx is not None and ctx.on_mesh:
        return _adamw_zero1(params, grads, state, lr, b1, b2, eps, weight_decay, grad_clip,
                            ctx, cfg, zero1)
    leaves = list(zip(*map(tree_leaves, (params, grads, state.mu, state.nu))))
    gnorm = torch.sqrt(sum(g.float().square().sum() for _, g, _, _ in leaves))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for p, g, m, v in leaves:
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g.square())
        pf = p.float()
        p.copy_(pf - lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * pf))
    return params, AdamWState(step, state.mu, state.nu), gnorm


def _adamw_zero1(params, grads, state: AdamWState, lr, b1, b2, eps, weight_decay, grad_clip,
                 ctx, cfg, zero1: bool = True) -> Tuple[object, AdamWState, torch.Tensor]:
    """``adamw_update`` on a mesh (the arithmetic is the same, on slices)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.sharding.specs import placement, tree_paths

    paths = [path for path, _ in tree_paths(params)]
    ps, ms, vs = tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)
    gs = tree_leaves(grads)
    # the gradients summed over the batch axes, in one f32 exchange
    flat = torch.cat([g.float().reshape(-1) for g in gs])
    flat = C.all_reduce_value(flat, ctx.batch_group)
    gs, at = [], 0
    for p in ps:
        gs.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    # the norm: model-split shares summed over the model axis, whole leaves once
    m = ctx.model_size
    split_sq = torch.zeros((), dtype=torch.float32, device=flat.device)
    whole_sq = torch.zeros((), dtype=torch.float32, device=flat.device)
    for path, g in zip(paths, gs):
        where = placement(cfg, m, path)
        if where is None:
            whole_sq = whole_sq + g.square().sum()
            continue
        dim, head = where
        share = g.narrow(dim, 0, head // m)
        split_sq = split_sq + share.square().sum()
        if head // m != g.shape[dim]:
            whole_sq = whole_sq + g.narrow(dim, head // m, g.shape[dim] - head // m).square().sum()
    gnorm = torch.sqrt(C.all_reduce_value(split_sq, ctx.model_group) + whole_sq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for path, p, g, mo, vo, z in zip(paths, ps, gs, ms, vs, _zero1_dims(ctx, cfg, params, zero1)):
        pz = p if z is None else C.batch_share(ctx, p, z)
        gz = (g if z is None else C.batch_share(ctx, g, z)) * scale
        mo.copy_(b1 * mo + (1 - b1) * gz)
        vo.copy_(b2 * vo + (1 - b2) * gz.square())
        pf = pz.float()
        new = (pf - lr * ((mo / c1) / (torch.sqrt(vo / c2) + eps) + weight_decay * pf)).to(p.dtype)
        p.copy_(new if z is None else C.all_gather_batch(ctx, new, z))
    return params, AdamWState(step, state.mu, state.nu), gnorm
