"""Training: one eager train step (loss with remat, its gradients through
autograd, AdamW in place) and a simple synchronous driver.  The step runs
the models' differentiable math (``models.model.loss_fn``), never a kernel:
the kernels have no backward.  No ``torch.compile``.

With a mesh ``ctx`` the step is the sharded one: each rank's loss over its
batch rows and parameter shares (``sharding.specs.shard_params``), the
gradients summed over the batch axes and the update ZeRO-1
(``train.optimizer``); a checkpoint gathers the shares
(``specs.gather_params``) and rank 0 writes the file an unsharded run
would."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_unflatten,
)


@dataclass
class TrainState:
    params: dict
    opt: AdamWState
    step: int = 0


def make_train_step(
    cfg: ModelConfig,
    lr: float = 3e-4,
    remat: bool = True,
    aux_weight: float = 0.01,
    remat_policy: str = "full",
    ctx=None,
) -> Callable:
    """Returns ``train_step(params, opt, tokens, labels, frontend_emb=None) ->
    (params, opt, metrics)``.  The parameters must require grad; they and
    the optimizer's moments are updated in place, and ``metrics`` (loss,
    nll, aux, gnorm) stay device tensors.  On a mesh (``ctx``): this rank's
    shares and rows, ZeRO-1 AdamW."""

    def train_step(params, opt, tokens, labels, frontend_emb=None):
        leaves = tree_leaves(params)
        total, (nll, aux) = model_mod.loss_fn(
            cfg, params, tokens, labels, frontend_emb, remat=remat,
            aux_weight=aux_weight, remat_policy=remat_policy, ctx=ctx,
        )
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        params, opt, gnorm = adamw_update(params, tree_unflatten(params, grads), opt, lr=lr,
                                          ctx=ctx, cfg=cfg)
        metrics = {"loss": total.detach(), "nll": nll.detach(), "aux": aux.detach(),
                   "gnorm": gnorm}
        return params, opt, metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    params,
    batches: Iterator[Tuple[torch.Tensor, torch.Tensor]],
    steps: int,
    lr: float = 3e-4,
    log_every: int = 10,
    frontend_emb=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    ctx=None,
):
    """A simple synchronous training driver: ``steps`` steps over
    ``batches``; the metrics are read to the host only at a logged step
    (the first, then every ``log_every``), which prints the reference's
    line; a checkpoint every ``checkpoint_every`` steps.  Returns (params,
    opt, history).  On a mesh (``ctx``) ``batches`` yields this rank's
    rows, and only the mesh's first rank prints and writes."""
    from repro_torch.train.checkpoint import save_sharded

    for p in tree_leaves(params):
        p.requires_grad_(True)
    step_fn = make_train_step(cfg, lr=lr, ctx=ctx)
    opt = adamw_init(params, ctx, cfg)
    first = ctx is None or not ctx.on_mesh or (ctx.model_rank == 0 and ctx.batch_rank == 0)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        tokens, labels = next(batches)
        params, opt, metrics = step_fn(params, opt, tokens, labels, frontend_emb)
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if first:
                print(
                    f"step {i+1:5d} loss={m['loss']:.4f} nll={m['nll']:.4f} "
                    f"aux={m['aux']:.4f} gnorm={m['gnorm']:.2f}"
                )
        if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_sharded(checkpoint_path, params, i + 1, ctx, cfg)
    return params, opt, history
