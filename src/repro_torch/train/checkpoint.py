"""Flat-npz checkpoints of the port's parameter trees.

Keys are the ``/``-joined paths of the leaves in the per-layer layout
(``layers/3/attn/wq``); a bf16 leaf is stored as f32 under ``key::bf16``
(numpy has no bf16), and the step under ``__step__``, as the reference's
``_flatten`` stores them.  A sharded run (``save_sharded``) gathers every
rank's shares and rank 0 writes the file an unsharded run would."""
from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import tree_map

def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(params) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _paths(params):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + "::bf16"] = t.float().numpy()
        else:
            flat[key] = t.numpy()
    return flat


def save_checkpoint(path: str, params, step: int = 0) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params)
    flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def save_sharded(path: str, params, step: int, ctx=None, cfg=None) -> str:
    """``save_checkpoint`` of a run on a mesh (``ctx``): the full tree
    gathered from the model axis (a collective: every rank calls this) and
    written by the mesh's first rank only.  Without a mesh, the file."""
    if ctx is None or not ctx.on_mesh:
        return save_checkpoint(path, params, step)
    from repro_torch.sharding.specs import gather_params

    full = gather_params(ctx, cfg, params)
    if ctx.model_rank == 0 and ctx.batch_rank == 0:
        save_checkpoint(path, full, step)
    return path


def load_checkpoint(path: str, like) -> Tuple[dict, int]:
    """Restore into the structure, dtypes and devices of ``like`` (a
    template tree); every stored leaf must have its template's shape and
    dtype.  Returns (params, step)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        keys = iter([k for k, _ in _paths(like)])

        def restore(leaf: torch.Tensor) -> torch.Tensor:
            key = next(keys)
            if leaf.dtype == torch.bfloat16:
                t = torch.from_numpy(data[key + "::bf16"])
                assert t.dtype == torch.float32, (key, t.dtype)
                t = t.to(torch.bfloat16)
            else:
                t = torch.from_numpy(data[key])
            assert t.dtype == leaf.dtype and t.shape == leaf.shape, (
                key, t.dtype, t.shape, leaf.dtype, leaf.shape)
            return t.to(leaf.device)  # lint: allow[MG105] a checkpoint's weights placed once, at load

        return tree_map(restore, like), step
