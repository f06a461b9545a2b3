"""Carry the JAX package's parameters into the port.

``from_numpy_params`` takes the JAX parameter tree with every leaf already
converted to numpy (e.g. ``jax.tree.map(np.asarray, params)``; this module
itself imports no JAX) and returns the port's layout: the layer-group axis
that the JAX init stacks with ``vmap`` is unstacked into a per-layer list.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_pattern


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy -> torch, bit-exact.  ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` rejects) go through a 16-bit integer view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)  # lint: allow[MG105] the weight bridge places reference weights once, at set-up


def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(cfg: ModelConfig, layers: List[Dict]) -> List[Dict]:
    """Group-stacked ``layers[j]`` (leaves (G, ...)) -> per-layer list in
    model order (layer ``g * len(pattern) + j``)."""
    pattern = layer_pattern(cfg)
    G = cfg.num_layers // len(pattern)
    out = []
    for g in range(G):
        for j in range(len(pattern)):
            out.append(_tree_to(layers[j], lambda a, g=g: np.asarray(a)[g]))
    return out


def from_numpy_params(cfg: ModelConfig, np_params: Dict, device="cuda") -> Dict:
    """The port's parameters from the JAX tree of numpy arrays."""
    dev = resolve_device(device)
    conv = lambda a: to_tensor(a, dev)  # noqa: E731
    out = {k: conv(v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [_tree_to(lp, conv)
                     for lp in unstack_layers(cfg, np_params["layers"])]
    return out
