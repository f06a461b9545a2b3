"""The cache-ownership check: the port's counterpart of XLA's
``input_output_alias`` verification.

In the JAX package a decode launch donates the cache and XLA aliases it to
the output; a dropped donation silently turns the in-place update into a
copy.  In the port the engine writes its cache, page pools and graph carries
in place, and its captured CUDA graphs hold their addresses.  So the
contract is: between two decode ticks of one batch no such tensor moves.

* ``check_pointers`` (under ``sanitize(pointers=True)``) records each
  tensor's ``data_ptr()`` the first time it is seen for an owner and batch
  key, and compares at every later call: a moved tensor is a
  ``DonationViolation``.  The engine calls it after every decode tick; its
  batch key changes only where the engine itself reallocates (a new batch
  size, a wider carry), which also drops the graphs.
* ``poison`` (under ``sanitize(poison=True)``) fills tensors the engine
  drops with NaN (integer ones with the dtype's least value) before they are
  released, so a retained reference reads poison, not stale values.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable

import torch

from repro_torch.analysis import runtime


def check_pointers(owner: Hashable, key: Hashable, tensors: Dict[str, torch.Tensor]) -> None:
    """Hold ``tensors`` ({name: tensor}) to the addresses first seen for
    ``(owner, key)``; no-op unless the active sanitizer checks pointers."""
    san = runtime.current()
    if san is None or not san.pointers:
        return
    book = san.pointer_book.setdefault((owner, key), {})
    moved = []
    for name, t in tensors.items():
        ptr = t.data_ptr()
        if book.setdefault(name, ptr) != ptr:
            moved.append(name)
    san.pointer_checks += 1
    if moved:
        san.fail(runtime.DonationViolation,
                 f"{owner}: {', '.join(moved)} moved between decode ticks of batch key "
                 f"{key!r} (the captured graphs hold the old addresses)",
                 san.pointer_violations)


def poison(tensors: Iterable[torch.Tensor]) -> None:
    """Fill dropped tensors with NaN (integers: the dtype's least value);
    no-op unless the active sanitizer poisons."""
    san = runtime.current()
    if san is None or not san.poison:
        return
    for t in tensors:
        t.fill_(float("nan") if t.is_floating_point() else torch.iinfo(t.dtype).min)
        san.poisoned += 1
