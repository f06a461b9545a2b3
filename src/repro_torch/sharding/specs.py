"""The expert-parallel context threaded through the engine.

``ShardCtx`` names the ``torch.distributed`` process group whose ranks share
one MoE decode stage, and how they share it (``moe_dispatch``):

* ``"a2a"``: tokens and experts split over the group; routed copies go to
  their expert's owner by ``all_to_all_single`` and come back the same way
  (``distributed.ep_engine``);
* ``"psum"``: tokens replicated, experts split, partial outputs summed by
  ``all_reduce``;
* ``"grouped"``: the single-device capacity-bucketed grouped dispatch.

A ``ShardCtx()`` without a group is the single-device context: an engine
given one is the single-device engine.  The reference's parameter and cache
sharding rules belong to the model-sharding path and are not ported here,
nor is its ``moe_capacity``, the grouped prefill's capacity override: the
port's prefill probes its own capacity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

@dataclass(frozen=True)
class ShardCtx:
    """``group``: a ``torch.distributed`` process group (None: no group)."""

    group: Optional[Any] = None
    moe_dispatch: str = "a2a"

    @property
    def model_size(self) -> int:
        """Ranks in the group, 1 without a group."""
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank in the group, 0 without a group."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)
