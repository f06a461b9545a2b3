"""AdamW on the port's parameter trees (dicts and lists of tensors), with the
reference's arithmetic in the reference's order: the global f32 gradient
norm, one clip scale, the bias corrections, then ``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` in f32, cast back to ``p``'s dtype.
(``torch.optim.AdamW`` decays the weights before the step and folds the
corrections into the step size, which rounds differently.)  The update is
in place, a leaf at a time.  Nothing is read back to the host: the step
count and the norm stay device tensors.

On a mesh (``ctx``, ``cfg``; the parameters are this rank's tensors,
``sharding.specs.shard_params``) the update is ZeRO-1 when the parameters
are (``shard_params(..., zero1=True)``): a leaf held as its slice over the
batch axes gets its gradient as that slice, already summed over them (the
reduce-scatter of ``collectives.gather_batch``), and its moments cover the
same slice; every other leaf's gradient is summed over the batch axes here,
in one f32 exchange (``batch_summed``).  The moments always have the
parameters' shapes: with whole parameters (the reference's
``weights="tp"``) they are whole too.  The global norm counts every element
once over the data and model axes."""
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


def adamw_init(params) -> AdamWState:
    """Zero moments in f32 of the parameters' shapes (on a mesh this rank's
    tensors: its shares, and its ZeRO-1 slices where it holds them)."""
    dev = tree_leaves(params)[0].device
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                                   device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


def _batch_dims(ctx, cfg, params) -> List:
    """Per leaf, the dim on which this rank holds its ZeRO-1 slice (None:
    whole over the batch axes)."""
    from repro_torch.sharding.specs import held_batch_dim, tree_paths

    return [held_batch_dim(ctx, cfg, path, tuple(p.shape)) for path, p in tree_paths(params)]


def batch_summed(ctx, cfg, params, grads) -> List[torch.Tensor]:
    """This rank's gradient leaves summed over the batch axes: a ZeRO-1
    slice's arrives summed (``collectives.gather_batch``'s backward) and
    passes as it is; every other leaf's is all-reduced, in one f32
    exchange.  Returns the leaves in tree order, f32."""
    from repro_torch.distributed import collectives as C

    gs = [g.float() for g in tree_leaves(grads)]
    whole = [i for i, z in enumerate(_batch_dims(ctx, cfg, params)) if z is None]
    if whole and ctx.batch_group is not None:
        flat = C.all_reduce_value(torch.cat([gs[i].reshape(-1) for i in whole]),
                                  ctx.batch_group)
        at = 0
        for i in whole:
            gs[i] = flat[at:at + gs[i].numel()].view(gs[i].shape)
            at += gs[i].numel()
    return gs


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
) -> Tuple[object, AdamWState, torch.Tensor]:
    """One step, IN PLACE: every parameter and both moments are written one
    leaf at a time (no second copy of the optimizer state is ever held).
    Returns (params, the new state, gnorm), the same parameter and moment
    tensors.  On a mesh (``ctx``, ``cfg``): ``_adamw_mesh``, with ``grads``
    this rank's (``batch_summed`` here)."""
    if ctx is not None and ctx.on_mesh:
        return _adamw_mesh(params, grads, state, lr, b1, b2, eps, weight_decay, grad_clip,
                           ctx, cfg)
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


def _adamw_mesh(params, grads, state: AdamWState, lr, b1, b2, eps, weight_decay, grad_clip,
                ctx, cfg) -> Tuple[object, AdamWState, torch.Tensor]:
    """``adamw_update`` on a mesh (the arithmetic is the same, on this rank's
    tensors)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.sharding.specs import placement, tree_paths

    paths = [path for path, _ in tree_paths(params)]
    ps, ms, vs = tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)
    gs = batch_summed(ctx, cfg, params, grads)
    # the norm: squares of model-split shares summed over the model axis, of
    # ZeRO-1 slices over the batch axes, every element once
    m = ctx.model_size
    sq = torch.zeros((2, 2), dtype=torch.float32, device=gs[0].device)  # [sliced][model]
    for path, g, z in zip(paths, gs, _batch_dims(ctx, cfg, params)):
        sliced = int(z is not None)
        where = placement(cfg, m, path)
        if where is None:
            sq[sliced, 0] += g.square().sum()
            continue
        dim, head = where
        sq[sliced, 1] += g.narrow(dim, 0, head // m).square().sum()
        if head // m != g.shape[dim]:
            sq[sliced, 0] += g.narrow(dim, head // m, g.shape[dim] - head // m).square().sum()
    over_batch = C.all_reduce_value(sq[1], ctx.batch_group)
    over_model = C.all_reduce_value(over_batch[1] + sq[0, 1], ctx.model_group)
    gnorm = torch.sqrt(over_model + over_batch[0] + sq[0, 0])
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for p, g, mo, vo in zip(ps, gs, ms, vs):
        g = g * scale
        mo.copy_(b1 * mo + (1 - b1) * g)
        vo.copy_(b2 * vo + (1 - b2) * g.square())
        pf = p.float()
        p.copy_(pf - lr * ((mo / c1) / (torch.sqrt(vo / c2) + eps) + weight_decay * pf))
    return params, AdamWState(step, state.mu, state.nu), gnorm
