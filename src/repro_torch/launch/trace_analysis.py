"""The port's counterpart of ``repro.launch.hlo_analysis``: FLOPs,
collectives and an op histogram read from a recorded trace.

The reference parses the optimized HLO text of a compiled step.  The port
has no HLO: PyTorch runs eagerly, so the dry run (``launch.dryrun``) runs
one rank's step under ``Recorder`` and keeps a **trace**, a list of records
(written as JSON lines by ``write_trace``):

* ``{"type": "op", "op": "aten.mm", "dtypes": [...], "shapes": [...],
  "flops": n}`` -- one per aten op, its outputs' dtypes and shapes and its
  FLOPs from ``torch.utils.flop_counter``'s formula registry (0 for an op
  it has no formula for);
* ``{"type": "collective", "kind": "all-reduce" | "all-gather" |
  "all-to-all", "axes": [...], "ranks": n, "sent_bytes": n, "bytes": n,
  ...}`` -- one per exchange of ``distributed.collectives``: the mesh axes
  of its group and their rank count, the staged buffer this rank sends
  (what ``collectives.STATS`` counts) and the size of the collective's
  result (the reference's measure: the gathered tensor of an all-gather,
  the whole tensor of an all-reduce).

Because the step runs eagerly, its layer loop is unrolled in the trace:
every layer's ops and collectives appear once each, so no loop trip counts
are recovered or needed (the reference scales ``while`` bodies by them).

``Recorder`` also follows the live tensor storages of the step (a
dispatch-mode tracker: each op's output storages are held by weak
reference from their first sight to their release), which gives the step's
peak beside the storages it started with.
"""
from __future__ import annotations

import gzip
import json
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the matmul family: what the reference's ``dot_flops`` counts (HLO ``dot``)
DOT_OPS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten._scaled_mm")


_NAMES: Dict[object, str] = {}          # op overload packet -> "aten.mm"


class _DtypeNames(dict):
    def __missing__(self, dtype):
        self[dtype] = str(dtype).replace("torch.", "")
        return self[dtype]


_DTYPES = _DtypeNames()


def _storages(tree) -> List[torch.UntypedStorage]:
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append(t.untyped_storage())
    return out


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for st in _storages(tree):
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class Recorder(TorchDispatchMode):
    """Record every aten op and every ``distributed.collectives`` exchange
    run inside the block into ``records``, and follow the live storages.

    ``mesh`` (``sharding.specs.Mesh``) names a collective's group by its
    axes.  ``hold(tree)`` counts ``tree``'s storages as live from the
    start (the step's arguments); ``live_bytes`` and ``peak_bytes`` are the
    bytes of the live storages now and at their most."""

    def __init__(self, mesh=None) -> None:
        super().__init__()
        self.records: List[dict] = []
        self._axes = {} if mesh is None else {id(g): list(a) for a, g in mesh.groups.items()}
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._observing = None

    # -- storages ------------------------------------------------------------
    def _gone(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def _track(self, st: torch.UntypedStorage) -> None:
        key = id(st)
        n = st.nbytes()
        entry = self._live.get(key)
        if entry is not None and entry[0]() is st:
            if n != entry[1]:                    # resized in place
                self.live_bytes += n - entry[1]
                self._live[key] = (entry[0], n)
        else:
            self._live[key] = (weakref.ref(st, lambda r, k=key: self._gone(k, r)), n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def hold(self, tree) -> None:
        for st in _storages(tree):
            self._track(st)

    # -- records -------------------------------------------------------------
    def _collective(self, rec: dict) -> None:
        group = rec.pop("group")
        rec = {"type": "collective", **rec, "axes": self._axes.get(id(group))}
        self.records.append(rec)

    def __enter__(self):
        from repro_torch.distributed import collectives

        self._observing = collectives.observed(self._collective)
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observing.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = ([out] if isinstance(out, torch.Tensor)
                else [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
        for t in outs:
            self._track(t.untyped_storage())
        packet = func._overloadpacket
        name = _NAMES.get(packet)
        if name is None:
            name = _NAMES[packet] = str(packet)
        if not name.startswith("prim."):                # prim: metadata queries
            formula = flop_registry.get(packet)
            flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
            self.records.append({
                "type": "op", "op": name, "dtypes": [_DTYPES[t.dtype] for t in outs],
                "shapes": [list(t.shape) for t in outs], "flops": flops})
        return out


# ---------------------------------------------------------------------------
# Traces on disk
# ---------------------------------------------------------------------------
def write_trace(path: str, trace: Iterable[dict]) -> None:
    """JSON lines, gzip-compressed when ``path`` ends in ``.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for rec in trace:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def read_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# The reference's measures
# ---------------------------------------------------------------------------
def _collectives(trace: Iterable[dict]):
    return (r for r in trace if r.get("type") == "collective")


def collective_stats(trace: Iterable[dict]) -> Dict[str, Dict[str, int]]:
    """Per collective kind: ``count``, ``bytes`` (the results' sizes, the
    reference's measure) and ``sent_bytes`` (what this rank staged)."""
    stats: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"count": 0, "bytes": 0, "sent_bytes": 0})
    for r in _collectives(trace):
        s = stats[r["kind"]]
        s["count"] += 1
        s["bytes"] += r["bytes"]
        s["sent_bytes"] += r["sent_bytes"]
    return dict(stats)


def total_collective_bytes(trace: Iterable[dict]) -> float:
    """The results' bytes, an all-reduce weighted 2 (a ring's reduce-scatter
    and all-gather phases), as the reference weighs them."""
    total = 0.0
    for kind, d in collective_stats(trace).items():
        total += (2.0 if kind == "all-reduce" else 1.0) * d["bytes"]
    return total


def dot_flops(trace: Iterable[dict]) -> float:
    """The matmul family's FLOPs (``DOT_OPS``: 2 x M x N x K each)."""
    return float(sum(r["flops"] for r in trace
                     if r.get("type") == "op" and r["op"] in DOT_OPS))


def total_flops(trace: Iterable[dict]) -> float:
    """Every op's FLOPs that the formula registry counts."""
    return float(sum(r.get("flops", 0) for r in trace if r.get("type") == "op"))


def op_histogram(trace: Iterable[dict], top: Optional[int] = 20) -> Dict[str, int]:
    """Op-name histogram, most frequent first (diagnosing remat and
    redundant ops); collectives count under their kind."""
    counts: Dict[str, int] = defaultdict(int)
    for r in trace:
        counts[r["op"] if r.get("type") == "op" else r.get("kind", "?")] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])
