"""The port's sharding rules against the reference's, with no ranks.

The rules work on shapes and axis sizes alone, so a shape-only mesh checks
them at the production mesh's 16 x 16 (and the multi-pod 2 x 16 x 16): every
leaf of the port's per-layer tree gets the reference's spec (minus the
stacked layer-group dim) from ``param_shardings(zero1=True/False)`` and
``cache_shardings``, on full-size Mixtral-8x7B (8 experts on a 16-way model
axis: the hidden-dim fallback), Jamba-1.5-Large and Qwen1.5-4B (20 heads:
context parallelism), and on every smoke config.  The reference's mesh is a
``jax.sharding.Mesh`` over repeated host devices (Auto axes), as
``tests/test_sharding.py`` builds it.  Then what each rank holds
(``placement``): a split always matches the spec's model dim, and a leaf
kept whole where the spec splits it is one of the documented cases.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.specs import ShardCtx as JShardCtx  # noqa: E402
from repro.sharding.specs import cache_shardings as jcache_shardings  # noqa: E402
from repro.sharding.specs import param_shardings as jparam_shardings  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.specs import Mesh, ShardCtx  # noqa: E402


class Shape:
    """A leaf that is only a shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def dim(self):
        return len(self.shape)


def _jmesh(dims, names):
    n = int(np.prod(dims))
    return jax.sharding.Mesh(np.array(jax.devices() * n)[:n].reshape(dims), names)


def _ctxs(dims, names, batch):
    jctx = JShardCtx(mesh=_jmesh(dims, names), batch_axes=batch, model_axis="model")
    return jctx, mesh.make_ctx(Mesh(names, dims))


def _port_tree(cfg, jtree):
    """The port's per-layer tree of shapes from the reference's stacked one."""
    pattern = M.layer_pattern(cfg)
    G = cfg.num_layers // len(pattern)
    base = {k: v for k, v in jtree.items() if k != "layers"}
    layers = [jax.tree.map(lambda a: Shape(a.shape[1:]), jtree["layers"][j])
              for g in range(G) for j in range(len(pattern))]
    return {**jax.tree.map(lambda a: Shape(a.shape), base), "layers": layers}


def _jflat(tree):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = None if s is None else tuple(s.spec)
    return out


def _jkey(cfg, path):
    """The reference's key of a port leaf: layer i is pattern slot i % g."""
    parts = path.split("/")
    if parts[0] == "layers":
        parts[1] = str(int(parts[1]) % len(M.layer_pattern(cfg)))
    return "/".join(parts)


def _check_params(arch, dims, names, batch, smoke, zero1):
    jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jtree = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jctx, ctx = _ctxs(dims, names, batch)
    want = _jflat(jparam_shardings(jctx, jtree, zero1=zero1))
    tree = _port_tree(cfg, jtree)
    got = dict(specs.tree_paths(specs.param_shardings(ctx, tree, zero1=zero1)))
    assert len(got) == len(list(specs.tree_paths(tree)))
    for path, spec in got.items():
        ref = want[_jkey(cfg, path)]
        if path.startswith("layers"):
            assert ref[0] is None
            ref = ref[1:]
        assert spec == ref, (arch, path, spec, ref)
    return cfg, tree, got


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b", "qwen1.5-4b"])
def test_param_specs_equal_reference_at_production_mesh(arch, zero1):
    """Leaf for leaf, the reference's spec at (data 16, model 16)."""
    cfg, tree, got = _check_params(arch, (16, 16), ("data", "model"), ("data",), False, zero1)
    if arch == "mixtral-8x7b":                 # 8 experts, 16-way axis: F sharded
        assert got["layers/0/moe/experts_w_gate"][-1] == "model"
        assert got["layers/0/moe/experts_w_gate"][0] is None


def test_param_specs_equal_reference_on_multi_pod_mesh():
    """(pod 2, data 16, model 16): the batch axes are (pod, data)."""
    prod = mesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    cfg, _, got = _check_params("jamba-1.5-large-398b", (2, 16, 16), ("pod", "data", "model"),
                                ("pod", "data"), False, True)
    first = next(i for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")
    assert got[f"layers/{first}/attn/wq"] == (("pod", "data"), "model")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_leaf_gets_the_reference_spec(arch):
    """Every leaf of every smoke config's port tree gets a spec, equal to
    the reference's, at (data 2, model 2) and zero1."""
    _check_params(arch, (2, 2), ("data", "model"), ("data",), True, True)
    cfg = get_config(arch, smoke=True)
    ctx = mesh.make_ctx(Mesh(("data", "model"), (2, 2)))
    params = M.init_params(cfg, seed=0, device="cpu")
    got = list(specs.tree_paths(specs.param_shardings(ctx, params, zero1=True)))
    assert [p for p, _ in got] == [p for p, _ in specs.tree_paths(params)]
    assert all(len(s) == t.dim() for (_, s), (_, t) in zip(got, specs.tree_paths(params)))


@pytest.mark.parametrize("arch,smoke", [("mixtral-8x7b", False), ("jamba-1.5-large-398b", False),
                                        ("qwen1.5-4b", False), ("jamba-1.5-large-398b", True),
                                        ("mamba2-370m", True)])
def test_cache_specs_equal_reference(arch, smoke):
    """``cache_shardings`` leaf for leaf (the reference's group dim
    dropped), at (16, 16) for the full configs and (2, 2) for the smoke."""
    jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    dims = (2, 2) if smoke else (16, 16)
    jctx, ctx = _ctxs(dims, ("data", "model"), ("data",))
    B, T = 32, 64
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, T))
    want = _jflat(jcache_shardings(jctx, jcache))
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    pattern = len(M.layer_pattern(cfg))
    tree = [jax.tree.map(lambda a: Shape(a.shape[1:]), jcache[i % pattern])
            for i in range(cfg.num_layers)]
    got = dict(specs.tree_paths(specs.cache_shardings(ctx, tree)))
    assert len(got) == sum(len(c) for c in tree) and len(kinds) == len(tree)
    for path, spec in got.items():
        i, name = path.split("/")
        ref = want[f"{int(i) % pattern}/{name}"]
        assert ref[0] is None and spec == ref[1:], (path, spec, ref)


# what each rank holds differs from the spec only for these leaves
WHOLE_WHERE_SPEC_SPLITS = {"wB", "wC"}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("m", [2, 4, 16])
def test_placement_follows_the_spec_but_where_documented(arch, m):
    """A leaf a rank holds a share of is split on the spec's model dim
    (the SSM conv channels keep B and C whole past their ``xs`` share);
    a leaf held whole where the spec splits it is ``wB``/``wC``, a
    module whose heads / KV heads / hidden dim the model axis does not
    divide, or the embedding's or head's dim the axis does not divide."""
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        jtree = jax.eval_shape(lambda: JM.init_params(jget(arch, smoke=smoke),
                                                      jax.random.PRNGKey(0)))
        tree = _port_tree(cfg, jtree)
        ctx = mesh.make_ctx(Mesh(("data", "model"), (1, m)))
        got = dict(specs.tree_paths(specs.param_shardings(ctx, tree)))
        for path, leaf in specs.tree_paths(tree):
            where = specs.placement(cfg, m, path)
            model_dims = [i for i, a in enumerate(got[path]) if a == "model"]
            if where is not None:
                assert model_dims == [where[0]], (path, where, got[path])
                head = leaf.shape[where[0]] if not path.endswith("conv_w") \
                    else cfg.ssm_d_inner
                assert where[1] == head and head % m == 0, path
                continue
            if not model_dims:
                continue
            name = path.rsplit("/", 1)[-1]
            mod = path.split("/")[2] if path.startswith("layers") else path
            ok = (name in WHOLE_WHERE_SPEC_SPLITS
                  or (mod == "attn" and (cfg.num_heads % m or cfg.num_kv_heads % m))
                  or (mod == "ssm" and cfg.ssm_nheads % m)
                  or (mod == "ffn" and cfg.d_ff % m)
                  or (mod == "moe" and cfg.num_experts % m and cfg.moe_d_ff % m))
            assert ok, (arch, smoke, m, path, got[path])


def test_shard_and_gather_round_trip_in_one_process():
    """``shard_params`` then the shares concatenated back (what
    ``gather_params`` all-gathers) give the full tree on a model axis of 2,
    the SSM conv's B and C columns whole in both shares;
    ``shard_cache`` likewise; ``full_shape`` recovers every leaf's shape."""
    cfg = replace(get_config("jamba-1.5-large-398b", smoke=True), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    m = 2
    shares = []
    for r in range(m):
        ctx = ShardCtx(mesh=Mesh(("data", "model"), (1, m), (0, r)), batch_axes=("data",),
                       model_axis="model")
        shares.append(specs.shard_params(ctx, cfg, params))
    for path, full in specs.tree_paths(params):
        parts = [dict(specs.tree_paths(s))[path] for s in shares]
        assert specs.full_shape(cfg, m, path, parts[0].shape) == tuple(full.shape)
        where = specs.placement(cfg, m, path)
        if where is None:
            assert all(torch.equal(p, full) for p in parts), path
            continue
        dim, head = where
        n = head // m
        joined = torch.cat([p.narrow(dim, 0, n) for p in parts], dim=dim)
        tail = [p.narrow(dim, n, p.shape[dim] - n) for p in parts]
        assert torch.equal(torch.cat([joined] + tail[:1], dim=dim), full), path
        assert all(torch.equal(t, tail[0]) for t in tail), path
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    local = specs.shard_cache(ctx, cfg, cache)
    assert local[0]["conv"].shape[-1] == cfg.ssm_d_inner // m + 2 * cfg.ssm_state
    assert local[0]["h"].shape[1] == cfg.ssm_nheads // m


def test_shard_ctx_keeps_the_engine_contract():
    """``ShardCtx(group=...)`` defaults to a2a (the engine's callers get what
    they got), a mesh context to the reference's psum; a group and a mesh
    together are refused; ``make_ctx`` names the batch and model axes."""
    assert ShardCtx(group=object()).moe_dispatch == "a2a"
    assert ShardCtx(group=object(), moe_dispatch="psum").moe_dispatch == "psum"
    assert ShardCtx().moe_dispatch == "psum" and not ShardCtx().on_mesh
    ctx = mesh.make_ctx(mesh.make_production_mesh(), seq_shard=True)
    assert (ctx.batch_axes, ctx.model_axis, ctx.model_size, ctx.batch_size) == (
        ("data",), "model", 16, 16)
    assert ctx.seq_split(4096) and not ctx.seq_split(1)
    assert not ctx.for_sequence(1).seq_shard and ctx.for_sequence(32).seq_shard
    with pytest.raises(ValueError, match="group or a mesh"):
        ShardCtx(group=object(), mesh=mesh.make_production_mesh())
    assert mesh.mesh_shape_for(2) == (1, 2) and mesh.mesh_shape_for(256) == (16, 16)
    assert mesh.mesh_shape_for(512) == (32, 16)
