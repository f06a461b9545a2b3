"""Meshes of rank processes, and the process groups behind them, on one host.

The reference builds ``jax`` device meshes (``make_production_mesh``,
``make_debug_mesh``, ``make_ctx``).  Here a mesh is a ``sharding.specs.Mesh``
over ``torch.distributed`` ranks, one process each:

* ``make_production_mesh(multi_pod)`` -- the reference's (16, 16) data x
  model and (2, 16, 16) pod x data x model shapes, as shapes only (no
  ranks): what the sharding rules read;
* ``make_mesh(dims, names)`` / ``make_debug_mesh(data, model)`` -- a mesh
  over the ranks of this process's default group, rank ``r`` at the
  row-major coordinate of ``r`` (the model axis fastest), with one group per
  set of axes (``dist.new_group``; every rank makes every group, in the same
  order);
* ``make_ctx(mesh, seq_shard)`` -- the ``ShardCtx`` of a mesh;
* ``group(world_size=1)`` -- a one-rank gloo group in this process (the
  in-process counterpart of the reference's ``make_debug_mesh(1, 1)``);
* ``spawn(fn, n, args)`` -- start ``n`` rank processes, each joined to a
  gloo group of ``n`` ranks, run ``fn(rank, n, group, *args)`` in each and
  return their results in rank order.

Groups rendezvous through a file in a fresh temporary directory, so that
groups started side by side never race for a TCP port, and every group gets
a timeout in seconds: a rank whose peers stop answering fails its collective
instead of waiting for the default half hour.  The transport is gloo, which
exchanges host tensors (NCCL refuses two ranks on one card); the
expert-parallel stage and the model-sharding path stage their device tensors
through the host themselves (``distributed.ep_engine``,
``distributed.collectives``).
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from itertools import combinations
from typing import Any, Callable, Iterator, List, Sequence, Tuple

from repro_torch.sharding.specs import Mesh, ShardCtx

GROUP_TIMEOUT_S = 60.0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh shapes (no ranks): single pod (data
    16, model 16), multi-pod (pod 2, data 16, model 16)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_ctx(mesh: Mesh, *, seq_shard: bool = False) -> ShardCtx:
    """The mesh's ``ShardCtx``: ``pod``/``data`` are the batch axes,
    ``model`` the model axis; the MoE dispatch is ``"psum"``."""
    names = mesh.axis_names
    batch = tuple(n for n in names if n in ("pod", "data"))
    model = "model" if "model" in names else None
    return ShardCtx(mesh=mesh, batch_axes=batch, model_axis=model, seq_shard=seq_shard)


def make_mesh(dims: Sequence[int], names: Sequence[str]) -> Mesh:
    """A mesh over every rank of the default group (``prod(dims)`` of them):
    rank r sits at the row-major coordinate of r.  Makes one group per
    non-empty set of axes of more than one rank (each rank keeps the one it
    belongs to); every rank must call this, with the same arguments."""
    import numpy as np
    import torch.distributed as dist

    dims, names = tuple(int(d) for d in dims), tuple(names)
    n = int(np.prod(dims))
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {dims} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    grid = np.arange(n).reshape(dims)
    rank = dist.get_rank()
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups = {}
    for k in range(1, len(dims) + 1):
        for axes in combinations(range(len(dims)), k):
            if int(np.prod([dims[a] for a in axes])) == 1:
                continue
            others = [a for a in range(len(dims)) if a not in axes]
            moved = np.moveaxis(grid, others + list(axes), list(range(len(dims))))
            for members in moved.reshape(-1, int(np.prod([dims[a] for a in axes]))):
                g = dist.new_group(ranks=[int(r) for r in members])
                if rank in members:
                    groups[tuple(names[a] for a in axes)] = g
    return Mesh(names, dims, coords, groups)


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the default group's ranks (tests)."""
    return make_mesh((data, model), ("data", "model"))


def mesh_shape_for(n_ranks: int) -> Tuple[int, int]:
    """The reference launcher's rule for ``n`` devices: data =
    max(1, n // 16), model = n // data."""
    data = max(1, n_ranks // 16)
    return data, n_ranks // data


def init_group(rank: int, world_size: int, rendezvous: str,
               timeout_s: float = GROUP_TIMEOUT_S):
    """Join this process to the gloo group of ``world_size`` ranks that meets
    at file ``rendezvous``; returns the group (the process's default one)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


@contextlib.contextmanager
def group(world_size: int = 1, timeout_s: float = GROUP_TIMEOUT_S) -> Iterator[Any]:
    """A group of ``world_size`` ranks in which this process is rank 0,
    destroyed on exit.  With ``world_size`` > 1 the other ranks must join
    from other processes (``spawn`` starts them)."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        g = init_group(0, world_size, os.path.join(tmp, "rendezvous"), timeout_s)
        try:
            yield g
        finally:
            dist.destroy_process_group()


def _rank_main(fn: Callable, rank: int, n: int, rendezvous: str, timeout_s: float,
               args: Sequence, results) -> None:
    import torch.distributed as dist

    try:
        g = init_group(rank, n, rendezvous, timeout_s)
        # plain pickle bytes: tensors copied, not shared through file
        # descriptors that die with this process
        results.put((rank, True, pickle.dumps(fn(rank, n, g, *args))))
    except BaseException:             # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), timeout_s: float = 600.0,
          group_timeout_s: float = GROUP_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, n, group, *args)`` in ``n`` spawned processes joined by
    a gloo group; return the ``n`` results in rank order.  ``fn`` and
    ``args`` are pickled (``fn`` by import path), and so are the results.

    Raises ``RuntimeError`` with the rank's traceback when a rank fails, and
    when the ranks have not all finished within ``timeout_s``; either way
    every process is stopped before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, rendezvous, group_timeout_s, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < n and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"ranks {sorted(set(range(n)) - set(out))} did not finish " \
                              f"within {timeout_s:.0f} s"
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive() and p.exitcode != 0]
                    if dead:
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if failure is None else 0.1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failure is not None:
        raise RuntimeError(f"expert-parallel ranks: {failure}")
    return [out[r] for r in range(n)]
