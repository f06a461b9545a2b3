"""AdamW on the port's parameter trees (dicts and lists of tensors), with the
reference's arithmetic in the reference's order: the global f32 gradient
norm, one clip scale, the bias corrections, then ``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` in f32, cast back to ``p``'s dtype.
(``torch.optim.AdamW`` decays the weights before the step and folds the
corrections into the step size, which rounds differently.)  The update is
in place, a leaf at a time.  Nothing is read back to the host: the step
count and the norm stay device tensors."""
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
    dev = tree_leaves(params)[0].device
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                                   device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())


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
) -> Tuple[object, AdamWState, torch.Tensor]:
    """One step, IN PLACE: every parameter and both moments are written one
    leaf at a time (no second copy of the optimizer state is ever held).
    Returns (params, the new state, gnorm), the same parameter and moment
    tensors."""
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
