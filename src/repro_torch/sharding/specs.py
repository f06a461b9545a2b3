"""Sharding context and logical-axis rules.

``ShardCtx`` serves two callers:

* the expert-parallel serving engine: ``ShardCtx(group=g, moe_dispatch=...)``
  names the ``torch.distributed`` process group whose ranks share one MoE
  decode stage (``distributed.ep_engine``), and how they share it:
  ``"a2a"`` (the default there), ``"psum"``, or ``"grouped"`` (the
  single-device capacity dispatch);
* the model-sharding path: ``ShardCtx(mesh=m, batch_axes=("data",),
  model_axis="model", seq_shard=...)`` (``launch.mesh.make_ctx``) threads a
  data x model ``Mesh`` of rank processes through ``forward``, ``loss_fn``,
  ``prefill``, ``decode_step``, ``greedy_generate`` and training.  Batch
  rows split over the batch axes; heads, FFN columns, experts and the
  vocabulary over the model axis; with ``seq_shard`` the residual stream
  splits over the model axis by sequence (Megatron-SP).  Its MoE dispatch
  defaults to the reference's ``"psum"``.

A ``ShardCtx()`` with neither is the single-device context.

The parameter and cache rules (``_rule_for``, ``param_shardings``,
``cache_shardings``) are the reference's: they work on shapes and axis sizes
alone, so a shape-only ``Mesh`` (``launch.mesh.make_production_mesh``) checks
them at 16 x 16 without 256 ranks.  A spec is a tuple with one entry per
dim: None (replicated), an axis name, or a tuple of axis names.

What each rank really holds (``placement``, ``shard_params``) is the spec's
model dim, read at the leaf's full shape (``leaf_shapes``), except where a
contiguous split would not match the computation; there the leaf is kept
whole on every rank:

* attention weights when the model axis does not divide the heads (context
  parallelism), and ``wk``/``wv`` when it does not divide the KV heads;
* the SSM's ``wB``/``wC`` (one group, shared by every head) and the
  ``[xs | B | C]`` channels of ``conv_w``, which keep their ``xs`` share
  and all of B and C (``conv_b`` is whole, as its spec says);
* a module whose split the model axis does not divide (all its weights).

Only the model axis splits parameters: the reference's ZeRO-1 ``"batch"``
dim splits the optimizer state (``train.optimizer``), not the weights.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of rank processes: ``axis_names`` and their sizes (``dims``),
    this process's coordinate on each (``coords``; None for a shape-only
    mesh) and, per tuple of axis names, the ``torch.distributed`` group of
    the ranks that share every other coordinate (``groups``)."""

    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]] = None
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def coord(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        if self.coords is None:
            raise ValueError("a shape-only mesh has no ranks")
        i = 0
        for a in axes:
            j = self.axis_names.index(a)
            i = i * self.dims[j] + self.coords[j]
        return i


def _axis_size(mesh: Optional[Mesh], axes) -> int:
    if mesh is None or axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardCtx:
    """``group``: the expert-parallel engine's process group.  ``mesh``,
    ``batch_axes``, ``model_axis``, ``seq_shard``: the model-sharding path.
    ``moe_dispatch`` defaults to ``"a2a"`` with a group and ``"psum"``
    otherwise."""

    group: Optional[Any] = None
    moe_dispatch: str = ""
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    seq_shard: bool = False

    def __post_init__(self) -> None:
        if self.group is not None and self.mesh is not None:
            raise ValueError("ShardCtx takes a process group or a mesh, not both")
        if not self.moe_dispatch:
            object.__setattr__(self, "moe_dispatch",
                               "a2a" if self.group is not None else "psum")

    # -- sizes and ranks ---------------------------------------------------
    @property
    def model_size(self) -> int:
        """Ranks of the model axis (or of the engine's group), 1 without."""
        if self.group is not None:
            import torch.distributed as dist

            return dist.get_world_size(self.group)
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def rank(self) -> int:
        """This process's rank in the engine's group (or on the model axis),
        0 without."""
        if self.group is not None:
            import torch.distributed as dist

            return dist.get_rank(self.group)
        return self.model_rank

    @property
    def batch_size(self) -> int:
        """Ranks over the batch axes (the data-parallel degree)."""
        if self.mesh is None:
            return 1
        return _axis_size(self.mesh, self.batch_axes)

    @property
    def model_rank(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 0
        return self.mesh.coord((self.model_axis,))

    @property
    def batch_rank(self) -> int:
        if self.mesh is None or not self.batch_axes:
            return 0
        return self.mesh.coord(self.batch_axes)

    @property
    def model_group(self):
        """The group of this rank's model axis (None when it has one rank)."""
        if self.model_size <= 1 or self.mesh is None:
            return None
        return self.mesh.groups[(self.model_axis,)]

    @property
    def batch_group(self):
        """The group of this rank's batch axes (None when they have one rank)."""
        if self.batch_size <= 1:
            return None
        return self.mesh.groups[tuple(self.batch_axes)]

    @property
    def on_mesh(self) -> bool:
        """True when the model code must run its sharded branch."""
        return self.mesh is not None and (self.model_size > 1 or self.batch_size > 1)

    def seq_split(self, S: int) -> bool:
        """The residual stream of a length-``S`` sequence is split over the
        model axis (``seq_shard`` and ``S`` divisible)."""
        m = self.model_size
        return self.seq_shard and m > 1 and S % m == 0

    def for_sequence(self, S: int) -> "ShardCtx":
        """This context for a pass over ``S`` positions: ``seq_shard`` kept
        only when ``S`` splits (the layers read ``residual_split``)."""
        if self.seq_shard and not self.seq_split(S):
            return replace(self, seq_shard=False)
        return self

    @property
    def residual_split(self) -> bool:
        """Inside a pass (``for_sequence``): the residual stream is split
        over the model axis by sequence."""
        return self.seq_shard and self.model_size > 1

    # -- logical axes ------------------------------------------------------
    def resolve(self, logical) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        if logical == "batch":
            return tuple(self.batch_axes) or None
        if logical == "model":
            return (self.model_axis,) if self.model_axis else None
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical_axes, shape: Optional[Sequence[int]] = None) -> Tuple:
        """The spec of logical per-dim axes, dropping dims they do not divide
        (the reference's ``ShardCtx.spec``): per dim None, an axis name, or a
        tuple of names."""
        out = []
        for i, la in enumerate(logical_axes):
            phys = self.resolve(la)
            if phys is not None and shape is not None:
                if shape[i] % _axis_size(self.mesh, phys) != 0:
                    phys = None
            out.append(None if phys is None else (phys[0] if len(phys) == 1 else tuple(phys)))
        return tuple(out)


# ---------------------------------------------------------------------------
# Parameter sharding rules (the reference's, on the port's per-layer tree)
# ---------------------------------------------------------------------------
def _rule_for(path: str, shape: Tuple[int, ...], zero1: bool) -> Tuple:
    """Logical axes per dim for a parameter identified by its path.

    ``zero1`` additionally puts ``'batch'`` on a replicated large dim
    (ZeRO-1): the dim whose optimizer state splits over the data axis."""
    d = None  # replicated marker
    data = "batch" if zero1 else None

    def dims(*axes):
        return tuple(axes)

    if len(shape) == 0 or "norm" in path or path.endswith("scale") or path.endswith("bias_norm"):
        return dims(*([d] * len(shape)))
    # MoE expert stacks: (E, in, out) -- expert parallelism on dim 0
    if "experts" in path and len(shape) == 3:
        if "w_down" in path:
            return dims("model", d, data)
        return dims("model", data, d)
    if "router" in path:
        return dims(data, d)[: len(shape)]
    if "embed" in path:
        return dims(d, "model")          # (V, D): shard D
    if "lm_head" in path:
        return dims(data, "model")       # (D, V): shard V
    # attention projections
    if any(k in path for k in ("wq", "wk", "wv")):
        if len(shape) == 1:              # bias (H*hd,)
            return dims("model")
        return dims(data, "model")       # (D, H*hd)
    if "wo" in path:
        return dims("model", data)       # (H*hd, D)
    # dense FFN
    if any(k in path for k in ("w_gate", "w_up")):
        return dims(data, "model")
    if "w_down" in path:
        return dims("model", data)
    # SSM projections
    if any(k in path for k in ("wz", "wx", "wB", "wC", "wdt", "in_proj")):
        return dims(data, "model")[: len(shape)]
    if "out_proj" in path:
        return dims("model", data)
    if "conv" in path:
        return dims(d, "model")[: len(shape)]  # (width, channels)
    if path.endswith("A_log") or path.endswith("D") or path.endswith("dt_bias"):
        return dims("model")[: len(shape)]
    return dims(*([d] * len(shape)))


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of dicts by key and lists by index, ``/``-joined
    (``layers/3/attn/wq``), in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _tree_with(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its form."""
    if isinstance(tree, dict):
        return {k: _tree_with(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_with(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def logical_axes(m: int, path: str, shape: Tuple[int, ...], zero1: bool) -> Tuple:
    """A parameter's logical axes on a model axis of ``m`` ranks: ``_rule_for``
    with the reference's expert fallback (an expert count the model axis
    does not divide shards the hidden dim instead: tensor-parallel
    experts)."""
    logical = _rule_for(path, shape, zero1)
    if "experts" in path and len(shape) == 3 and shape[0] % max(m, 1) != 0:
        if "w_down" in path:
            logical = (None, "model", "batch" if zero1 else None)
        else:
            logical = (None, "batch" if zero1 else None, "model")
    return logical


def param_shardings(ctx: ShardCtx, params, *, zero1: bool = False):
    """The spec of every leaf of the port's parameter tree (None for each
    leaf without a mesh).  The port keeps no stacked layer-group dim, so a
    layer leaf's spec is the reference's without its leading None."""

    def one(path, leaf):
        if ctx.mesh is None:
            return None
        shape = tuple(leaf.shape)
        return ctx.spec(*logical_axes(ctx.model_size, path, shape, zero1), shape=shape)

    return _tree_with(params, one)


def cache_shardings(ctx: ShardCtx, cache):
    """Specs of decode caches (the port's per-layer list, no group dim).

    KV leaves (B, S, K, hd): batch over data; KV heads over model when
    divisible, else the sequence (context parallelism), else head_dim.  SSM
    state (B, nh, ns, hp): heads over model.  Conv state (B, W, ch):
    channels over model."""

    def one(path, leaf):
        if ctx.mesh is None:
            return None
        shape = tuple(leaf.shape)
        msize = max(ctx.model_size, 1)
        if path.endswith("conv"):
            logical = ("batch", None, "model")
        elif path.endswith("k") or path.endswith("v"):
            if shape[2] % msize == 0:
                logical = ("batch", None, "model", None)
            elif shape[1] % msize == 0:
                logical = ("batch", "model", None, None)
            else:
                logical = ("batch", None, None, "model")
        elif path.endswith("h"):
            logical = ("batch", "model", None, None)
        else:
            logical = tuple([None] * len(shape))
        return ctx.spec(*logical, shape=shape)

    return _tree_with(cache, one)


# ---------------------------------------------------------------------------
# What each rank holds
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def leaf_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter leaf's full shape by path, a layer's as
    ``layers/*/...`` (layers of one kind alike): ``models.model.init_params``
    run on fake tensors, which take no memory and draw nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import init_params

    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
    return {_shape_key(path): tuple(t.shape) for path, t in tree_paths(params)}


def _shape_key(path: str) -> str:
    return re.sub(r"^layers/\d+/", "layers/*/", path)


def placement(cfg, m: int, path: str) -> Optional[Tuple[int, int]]:
    """How a leaf is split over a model axis of ``m`` ranks: None (whole on
    every rank), or ``(dim, head)``: the first ``head`` entries of ``dim``
    (in the full tree) split into ``m`` contiguous shares, the entries past
    ``head`` whole on every rank.

    The split is the spec's model dim (``logical_axes`` at the leaf's full
    shape), but where a contiguous split would not match the computation
    (the module docstring's list): attention under context parallelism and
    ``wk``/``wv`` over undivided KV heads, a Mamba2 block over undivided
    heads, and its ``wB``/``wC``, stay whole; ``conv_w`` splits only its
    ``xs`` channels."""
    if m <= 1:
        return None
    shape = leaf_shapes(cfg)[_shape_key(path)]
    logical = logical_axes(m, path, shape, zero1=False)
    dim = next((i for i, a in enumerate(logical) if a == "model" and shape[i] % m == 0), None)
    if dim is None:
        return None
    leaf = path.rsplit("/", 1)[-1]
    if "/attn/" in path and (cfg.num_heads % m or (
            leaf.startswith(("wk", "wv")) and cfg.num_kv_heads % m)):
        return None
    if "/ssm/" in path:
        if cfg.ssm_nheads % m or leaf in ("wB", "wC"):
            return None
        if leaf == "conv_w":
            return (dim, cfg.ssm_d_inner)
    return (dim, shape[dim])


def local_share(t, where: Optional[Tuple[int, int]], m: int, r: int):
    """Rank ``r``'s share of the full leaf ``t`` under ``where``
    (``placement``'s)."""
    if where is None:
        return t
    dim, head = where
    n = head // m
    share = t.narrow(dim, r * n, n)
    if head == t.shape[dim]:
        return share
    import torch

    return torch.cat([share, t.narrow(dim, head, t.shape[dim] - head)], dim=dim)


def shard_params(ctx: ShardCtx, cfg, params):
    """This rank's tensors of the full parameter tree ``params`` (copies,
    so the full tree can be freed)."""
    m, r = ctx.model_size, ctx.model_rank
    return _tree_with(params, lambda path, t: local_share(
        t, placement(cfg, m, path), m, r).clone())


def gather_params(ctx: ShardCtx, cfg, local):
    """The full tree from every model rank's ``local`` tensors (detached):
    ``shard_params``' inverse.  A collective: every rank of the model axis
    calls it, and each gets the full tree."""
    from repro_torch.distributed import collectives

    m = ctx.model_size

    def one(path, t):
        t = t.detach()
        where = placement(cfg, m, path)
        if where is None:
            return t.clone()
        dim, head = where
        n = head // m
        full = collectives.all_gather_value(ctx, t.narrow(dim, 0, n).contiguous(), dim)
        if n == t.shape[dim]:
            return full
        import torch

        return torch.cat([full, t.narrow(dim, n, t.shape[dim] - n)], dim=dim)

    return _tree_with(local, one)


def cache_placement(cfg, m: int, kind: str, name: str) -> Optional[Tuple[int, int]]:
    """``placement`` for a decode cache leaf of a layer of ``kind``:
    attention ``k``/``v`` (B, span, K, hd) split on the KV heads when the
    model axis divides the heads and the KV heads, SSM ``h`` (B, nh, ns, hp)
    on the heads and ``conv`` (B, W - 1, di + 2 ns) as ``conv_w``'s
    channels; else whole."""
    if m <= 1:
        return None
    if kind == "attn":
        ok = cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
        return (2, cfg.num_kv_heads) if ok else None
    if cfg.ssm_nheads % m:
        return None
    return (1, cfg.ssm_nheads) if name == "h" else (2, cfg.ssm_d_inner)


def shard_cache(ctx: ShardCtx, cfg, cache):
    """This rank's share of full decode caches (the per-layer list)."""
    m, r = ctx.model_size, ctx.model_rank
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    return [{n: local_share(t, cache_placement(cfg, m, kind, n), m, r).clone()
             for n, t in c.items()} for kind, c in zip(kinds, cache)]


def full_shape(cfg, m: int, path: str, local_shape: Sequence[int]) -> Tuple[int, ...]:
    """The full-tree shape of a leaf from a rank's ``local_shape``."""
    where = placement(cfg, m, path)
    s = list(local_shape)
    if where is not None:
        dim, head = where
        s[dim] = head + (s[dim] - head // m)
    return tuple(s)


def zero1_dim(ctx: ShardCtx, cfg, path: str, local_shape: Sequence[int]) -> Optional[int]:
    """The dim of a leaf whose AdamW state splits over the batch axes under
    ZeRO-1: ``_rule_for``'s ``"batch"`` dim when the batch axes divide it
    (None: the state stays whole on every rank)."""
    if ctx.batch_size <= 1:
        return None
    shape = full_shape(cfg, ctx.model_size, path, local_shape)
    spec = ctx.spec(*logical_axes(ctx.model_size, path, shape, True), shape=shape)
    batch = ctx.spec("batch")[0]
    return next((i for i, a in enumerate(spec) if a == batch), None)
