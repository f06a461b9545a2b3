"""Profiler ranges of the serving path, written only while a
``torch.profiler`` session is active.

``span(name)`` is ``torch.profiler.record_function(name)`` inside a
profiling session and one shared null context outside it, so an unprofiled
server pays one flag read a span site and creates no ``RecordFunction``.
The ranges sit on the profiler's own timeline, beside the device's kernels
and copies, so a trace reader can put each idle gap of the device down to
the range the host was in.

The ranges, for an operator who profiles the server:

* ``serve.prefill`` -- one admission wave (``Server._prefill_wave``), from
  its start through its first tokens read back: the interval
  ``ServeReport.prefill_s`` adds.  Waves follow
  ``ServeReport.admission_waves`` in order.
* ``serve.decode`` -- one decode chunk (``Server._decode_tick``), from the
  chunk's start through its token read: the interval
  ``ServeReport.decode_s`` adds.  The tokens' emission and the finishes
  come after it.
* ``sync.<tag>`` -- every planned host read or host wait, the body of an
  ``analysis.runtime.allowed(tag)`` scope, under its tag
  (``token-readback``, ``prefill-capacity-probe``, ``decode-inputs``,
  ``expert-prefetch``, ``replan-counters``, ...).
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiling session is active;
    the shared null context otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL
