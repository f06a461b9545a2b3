"""Offline-protocol wrapper over ``serving.server.Server``.

Re-exports the request and report types and keeps ``serve_dataset``, which
serves a fixed request list to completion under either scheduler.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dag_builder import Plan
from repro_torch.core.hardware import HardwareProfile
from repro_torch.serving.sampling import SamplingParams  # noqa: F401  (re-export)
from repro_torch.serving.server import (  # noqa: F401  (re-exports)
    BatchResult,
    Request,
    RequestHandle,
    RequestResult,
    ServeConfig,
    Server,
    ServeReport,
    StreamConfig,
    pad_requests,
)
from repro_torch.serving.weights import ParamStore

__all__ = [
    "BatchResult", "Request", "RequestHandle", "RequestResult",
    "SamplingParams", "ServeConfig", "Server", "ServeReport", "StreamConfig",
    "pad_requests", "serve_dataset",
]


def serve_dataset(
    cfg: ModelConfig,
    params,
    requests: List[Request],
    plan: Plan,
    decode_len: int,
    max_seq: Optional[int] = None,
    scheduler: str = "static",
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    max_prompt_len: Optional[int] = None,
    hw: Optional[HardwareProfile] = None,
    stream_weights: bool = False,
    resident_bytes: Optional[float] = None,
    store: Optional[ParamStore] = None,
    kv_page_tokens: int = 0,
    device_kv_gb: Optional[float] = None,
    faults=None,
    device="cuda",
) -> ServeReport:
    """Serve a fixed request list to completion (the offline protocol):
    static accumulated waves or continuous in-flight batching, per-request
    ``decode_len`` honored, ``eos_id`` finishing a sequence early, ``hw``
    gating continuous admission by the Eq. 2 host KV budget;
    ``stream_weights``/``resident_bytes`` as in ``StreamConfig``, or a built
    ``store``; ``kv_page_tokens``/``device_kv_gb`` page the KV cache and
    ``faults`` arms a fault-injection plan, as in ``ServeConfig``."""
    assert scheduler in ("static", "continuous"), scheduler
    if not requests:
        return ServeReport(scheduler=scheduler)
    server = Server(
        cfg, params, plan,
        serve=ServeConfig(
            scheduler=scheduler, decode_len=decode_len, max_seq=max_seq,
            max_prompt_len=max_prompt_len, pad_id=pad_id, eos_id=eos_id,
            hw=hw, kv_page_tokens=kv_page_tokens, device_kv_gb=device_kv_gb,
            faults=faults,
        ),
        stream=StreamConfig(stream_weights=stream_weights,
                            resident_bytes=resident_bytes),
        store=store,
        device=device,
    )
    for r in requests:
        server.submit(r)
    return server.run()
