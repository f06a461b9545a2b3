"""Distributed serving: the expert-parallel MoE decode stage and
data-parallel replicas.

* ``ep_engine`` -- the collective MoE decode stage (pipelined all-to-all, or
  psum) that a ``ModuleBatchingEngine`` built with a ``ShardCtx`` naming a
  ``torch.distributed`` group selects, and the ``ExpertParallelEngine``
  facade;
* ``replicas`` -- ``ReplicaServer``: one arrival queue fanned across N
  ``Server`` replicas with a pluggable routing policy, failover and a
  merged report;
* ``collectives`` -- the model-sharding path's collectives over a mesh's
  model and batch axes, as autograd functions with exact gradients.
"""
from repro_torch.distributed.ep_engine import (
    ExpertParallelEngine,
    a2a_bytes_per_stage,
    pipeline_chunks,
    validate_ep_shard,
)
from repro_torch.distributed.replicas import ReplicaReport, ReplicaServer

__all__ = [
    "a2a_bytes_per_stage",
    "ExpertParallelEngine",
    "pipeline_chunks",
    "ReplicaReport",
    "ReplicaServer",
    "validate_ep_shard",
]
