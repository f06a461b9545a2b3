"""Parameter store the engine executes through (resident-only in this slice).

Every weight is pinned on the device: the base weights (embedding, final
norm, LM head) and every layer's modules.  Streaming a part of them from
host memory through a double-buffered window (the paper's S_Params /
S_Expert split) is the weight-streaming slice of the port, and asking for it
here raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import layer_schema

STREAMING_SLICE = ("weight streaming (a resident budget below the model) is "
                   "the weight-streaming slice of the port")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class ParamStore:
    """All weights device-resident; ``acquire(li)`` returns layer ``li``'s
    parameter dict (the resident tensors, never copies)."""

    def __init__(self, cfg: ModelConfig, params: Dict, device) -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        self.schema: List[Tuple[str, str]] = layer_schema(cfg)
        if len(params["layers"]) != len(self.schema):
            raise ValueError(
                f"{len(params['layers'])} layer dicts for {len(self.schema)} layers"
            )
        self.base: Dict = {k: _tree_to(v, self.device)
                           for k, v in params.items() if k != "layers"}
        self._layers: List[Dict] = [_tree_to(lp, self.device)
                                    for lp in params["layers"]]

    @classmethod
    def build(cls, cfg: ModelConfig, params: Dict, plan=None,
              stream_weights: bool = False,
              resident_bytes: Optional[float] = None,
              device="cuda") -> "ParamStore":
        if stream_weights or resident_bytes is not None:
            raise NotImplementedError(STREAMING_SLICE)
        return cls(cfg, params, device)

    @property
    def fully_resident(self) -> bool:
        return True

    def acquire(self, li: int) -> Dict:
        return self._layers[li]

    def resident_module_bytes(self) -> int:
        return tree_bytes(self.base) + tree_bytes(self._layers)
