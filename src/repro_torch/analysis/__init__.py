"""Static analysis and the runtime sanitizer: the port's standing contracts
as rules (the counterpart of the JAX package's ``repro.analysis``).

* runtime sanitizer -- ``analysis.sanitize(strict=True)`` guards the
  engine's decode regions against host reads outside planned ``allowed``
  scopes, and ``Sanitizer.steady()`` fails on a decode-graph capture in
  steady state (``registry``);
* cache ownership -- ``sanitize(pointers=True)`` holds the cache, page
  pools and graph carries to fixed addresses, ``poison=True`` fills dropped
  caches with NaN (``donation``);
* profiler ranges -- ``spans.span(name)`` writes a ``torch.profiler``
  range only while a profiling session is active (the module lists the
  ranges the server writes; ``allowed(tag)`` opens ``sync.<tag>``);
* AST lint -- ``python -m repro_torch.analysis.lint src/repro_torch``
  (rules MG101-MG107).
"""
from repro_torch.analysis.donation import check_pointers, poison
from repro_torch.analysis.markers import hot_path, is_hot_path
from repro_torch.analysis.registry import TraceKeySet, register_collective
from repro_torch.analysis.runtime import (
    DonationViolation,
    RetraceViolation,
    Sanitizer,
    SanitizerError,
    allowed,
    current,
    decode_region,
    sanitize,
)

__all__ = [
    "DonationViolation",
    "RetraceViolation",
    "Sanitizer",
    "SanitizerError",
    "TraceKeySet",
    "allowed",
    "check_pointers",
    "current",
    "decode_region",
    "hot_path",
    "is_hot_path",
    "poison",
    "register_collective",
    "sanitize",
]
