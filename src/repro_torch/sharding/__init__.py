from repro_torch.sharding.specs import ShardCtx

__all__ = ["ShardCtx"]
