"""Deterministic fault injection + recovery policies (see ``plan.py``)."""
from repro_torch.faults.plan import (  # noqa: F401
    FaultError,
    FaultPlan,
    FaultSpec,
    PageAllocOOM,
    RetryPolicy,
    StreamTimeoutError,
    TransientTransferError,
    armed,
    current,
    note,
    parse_spec,
    resolve,
    shielded,
)

__all__ = [
    "FaultError", "FaultPlan", "FaultSpec", "PageAllocOOM", "RetryPolicy",
    "StreamTimeoutError", "TransientTransferError", "armed", "current",
    "note", "parse_spec", "resolve", "shielded",
]
