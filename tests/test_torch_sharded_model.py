"""The port's model-sharding path against the JAX package, on the CPU, in f32.

Gloo ranks in spawned processes (``repro_torch.launch.mesh.spawn``), one
cached spawn per world size that builds each of its meshes in turn: 2 ranks
as (data 1, model 2) with ``seq_shard`` and (data 2, model 1); 4 ranks as
(2, 2) with ``seq_shard`` and (1, 4) without.  Each rank holds its shares of
the JAX package's weights (bridged) and its rows of the batch; the rank
bodies live in ``tests/torch_sharded_ranks.py``, which imports no JAX.
Against the JAX package's unsharded functions on the same weights:
``forward`` logits within 1e-4 relative (olmoe, mixtral, jamba, mamba2 smoke
and a 3-head config the model axis does not divide: context parallelism),
``decode_step`` from ``init_cache(ctx)`` (mixtral, jamba), the MoE
layer's psum capacity path, a2a, the replica split (E 2 on model 4) and the
hidden-dim fallback (E 3 on model 2) with their gradients, ``loss_fn`` (loss
1e-5, every gradient 1e-4 of its leaf's peak), one ZeRO-1 AdamW step (1e-6)
and ``greedy_generate``'s tokens (equal).  ``capacity_factor`` is 32, so no
routed copy is dropped.  One subprocess holds the port's (2, 2) forward to
the reference's own sharded forward on an Auto-axes mesh of 4 forced host
devices.  The training launcher's ``--ranks 2`` runs in this process.
"""
import os
import subprocess
import sys
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.generate import greedy_generate as jgreedy  # noqa: E402
from repro.train.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as jadamw_update  # noqa: E402
from repro_torch.bridge import unstack_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, DECODE = 4, 16, 4
REL, LOSS_REL, GRAD_REL, ADAM_REL = 1e-4, 1e-5, 1e-4, 1e-6
LR = 1e-2
ARCHS = {"olmoe": ("olmoe-1b-7b", {}), "mixtral": ("mixtral-8x7b", {}),
         "jamba": ("jamba-1.5-large-398b", {}),
         "mamba": ("mamba2-370m", {}),            # pure SSM, tied embeddings
         # 3 heads: no model axis of 2 or 4 divides them (context parallelism)
         "odd_heads": ("qwen1.5-4b", {"num_heads": 3, "num_kv_heads": 3})}
_MODELS: dict = {}
_WANT: dict = {}
_RUNS: dict = {}


def _model(name):
    """(JAX config, port config, JAX params, numpy params) in f32 with
    capacity factor 32."""
    if name not in _MODELS:
        arch, over = ARCHS[name]
        kw = dict(dtype="float32", capacity_factor=32.0, **over)
        jcfg, cfg = replace(jget(arch, smoke=True), **kw), replace(get_config(arch, smoke=True), **kw)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[name] = (jcfg, cfg, jp, jax.tree.map(np.asarray, jp))
    return _MODELS[name]


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def _moe_inputs(E):
    """Seeded MoE weights of the olmoe smoke shapes with E experts, and x."""
    cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype="float32",
                  capacity_factor=32.0, num_experts=E)
    jcfg = replace(jget("olmoe-1b-7b", smoke=True), dtype="float32",
                   capacity_factor=32.0, num_experts=E)
    rng = np.random.default_rng(E)
    D, F = cfg.d_model, cfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "experts_w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
         "experts_w_up": rng.standard_normal((E, D, F)) * D ** -0.5,
         "experts_w_down": rng.standard_normal((E, F, D)) * F ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return jcfg, cfg, p, x


def _grads_like(np_params, seed=5):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype),
                        np_params)


MOE = {"psum": (4, "psum"), "a2a": (4, "a2a"), "fallback": (3, "psum"),
       "replica": (2, "psum")}
# per world size: (mesh dims, seq_shard, cases), the meshes built in turn
PLAN = {
    2: [((1, 2), True, ["forward:olmoe", "forward:mixtral", "forward:jamba", "forward:mamba",
                        "forward:odd_heads", "loss:olmoe", "loss:jamba", "moe:psum", "moe:a2a",
                        "moe:fallback", "decode:mixtral", "decode:jamba", "generate"]),
        ((2, 1), False, ["forward:olmoe", "forward:jamba", "zero1"])],
    4: [((2, 2), True, ["forward:olmoe", "forward:mixtral", "forward:jamba", "forward:mamba",
                        "forward:odd_heads", "loss:jamba", "moe:psum", "moe:a2a", "zero1",
                        "decode:jamba", "generate"]),
        ((1, 4), False, ["forward:olmoe", "forward:jamba", "forward:odd_heads",
                         "moe:replica"])],
}


def _cases(kind):
    """(world size, mesh dims, case) of every planned case of ``kind``."""
    return [(n, dims, c) for n, meshes in PLAN.items() for dims, _, cs in meshes
            for c in cs if c.split(":")[0] == kind]


def _args(case):
    kind, _, what = case.partition(":")
    toks, labels = _tokens()
    if kind == "forward":
        return "forward", (_model(what)[1], _model(what)[3], toks)
    if kind == "loss":
        return "loss", (_model(what)[1], _model(what)[3], toks, labels)
    if kind == "decode":
        return "decode", (_model(what)[1], _model(what)[3], toks[:, :DECODE].copy())
    if kind == "moe":
        E, disp = MOE[what]
        _, cfg, p, x = _moe_inputs(E)
        return "moe", (cfg, p, x, disp, True)
    ol = _model("olmoe")
    if kind == "zero1":
        return "zero1", (ol[1], ol[3], _grads_like(ol[3]), LR)
    return "generate", (ol[1], ol[3], toks[:, :8].copy(), DECODE)


def _runs(n):
    """Every rank's results on ``n`` ranks: one spawn, cached."""
    if n not in _RUNS:
        plan = [(dims, seq, [(c + str(dims),) + _args(c) for c in cs])
                for dims, seq, cs in PLAN[n]]
        _RUNS[n] = mesh.spawn(ranks.mesh_rank, n, (plan,), timeout_s=600.0,
                              group_timeout_s=120.0)
    return _RUNS[n]


def _rows(dims, out):
    """The batch rows of the rank whose results are ``out``."""
    b, _ = out[f"coords{dims}"]
    n = B // dims[0]
    return slice(b * n, (b + 1) * n)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(np.asarray(want)).max()), 1e-30)


def _want_forward(name):
    key = ("forward", name)
    if key not in _WANT:
        jcfg, _, jp, _ = _model(name)
        logits, aux, _ = JM.forward(jcfg, jp, jnp.asarray(_tokens()[0]))
        _WANT[key] = (np.asarray(logits), float(aux))
    return _WANT[key]


def _want_grads(name):
    key = ("grads", name)
    if key not in _WANT:
        jcfg, cfg, jp, _ = _model(name)
        toks, labels = _tokens()
        (jl, _), jg = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jnp.asarray(toks), jnp.asarray(labels), remat=False),
            has_aux=True)(jp)
        jg = jax.tree.map(np.asarray, jg)
        _WANT[key] = (float(jl), {**{k: v for k, v in jg.items() if k != "layers"},
                                  "layers": unstack_layers(cfg, jg["layers"])})
    return _WANT[key]


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _ids(v):
    return str(v).replace(" ", "")


@pytest.mark.parametrize("n,dims,case", _cases("forward"), ids=_ids)
def test_sharded_forward_matches_reference(n, dims, case):
    """Each rank's rows of the logits within 1e-4 relative of the JAX
    unsharded forward; the aux loss (the small-batch dense path: every
    layer's over every token) equal within f32 rounding."""
    want, aux = _want_forward(case.split(":")[1])
    for out in _runs(n):
        got = out[case + str(dims)]
        assert _rel(got["logits"], want[_rows(dims, out)]) < REL
        assert abs(got["aux"] - aux) <= 1e-5 * max(abs(aux), 1.0)


@pytest.mark.parametrize("n,dims,case", _cases("loss"), ids=_ids)
def test_sharded_loss_and_grads_match_reference(n, dims, case):
    """``loss_fn`` (remat on, the vocabulary-parallel NLL) within 1e-5 of
    ``jax.value_and_grad``'s loss on every rank, and every leaf's gradient
    (summed over the data axis, gathered over the model axis) within 1e-4
    of its peak."""
    jl, jg = _want_grads(case.split(":")[1])
    outs = _runs(n)
    for out in outs:
        got = out[case + str(dims)]
        assert abs(got["loss"] - jl) / abs(jl) < LOSS_REL
    grads = outs[0][case + str(dims)]["grads"]
    assert len(grads) == len(jax.tree.leaves(jg))
    for path, g in grads.items():
        assert _rel(g, _at(jg, path)) < GRAD_REL, path


def _moe_want(E, disp, dims):
    """The JAX dense-combine layer's output, the gradients of sum(y * x),
    and the aux loss as the reference's sharded path defines it: each batch
    shard's (psum) or each rank's token chunk's (a2a), averaged."""
    jcfg, _, p, x = _moe_inputs(E)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(xx, pp):
        y, _ = jmoe.moe_apply_local(jcfg, pp, xx)
        return jnp.sum(y * xx), y

    (_, y), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    data, model = dims
    shards = []
    for b in range(data):
        rows = x[b * B // data:(b + 1) * B // data]
        chunks = ([rows[:, j * S // model:(j + 1) * S // model] for j in range(model)]
                  if disp == "a2a" else [rows])
        for c in chunks:
            _, idx, probs = jmoe.route(jcfg, jp["router"], jnp.asarray(c.reshape(-1, c.shape[-1])))
            shards.append(float(jmoe.load_balance_loss(jcfg, probs, idx)))
    return (np.asarray(y), np.asarray(dx), {k: np.asarray(v) for k, v in dw.items()},
            float(np.mean(shards)))


@pytest.mark.parametrize("n,dims,case", _cases("moe"), ids=_ids)
def test_sharded_moe_matches_reference(n, dims, case):
    """The MoE layer on a mesh -- the psum capacity path (E 4), a2a, the
    hidden-dim fallback (E 3 on model 2) and the replica split (E 2 on
    model 4) -- against the JAX dense combine: output and gradients within
    1e-4 relative, the aux loss within 1e-5 of the reference's definition
    for that path."""
    E, disp = MOE[case.split(":")[1]]
    y, dx, dw, aux = _moe_want(E, disp, dims)
    outs = _runs(n)
    for out in outs:
        got = out[case + str(dims)]
        rows = _rows(dims, out)
        assert _rel(got["y"], y[rows]) < REL
        assert _rel(got["dx"], dx[rows]) < REL
        assert abs(got["aux"] - aux) <= 1e-5 * max(abs(aux), 1.0)
        for k, v in got["dw"].items():
            assert _rel(v, dw[k]) < REL, k


@pytest.mark.parametrize("n,dims,case", _cases("zero1"), ids=_ids)
def test_zero1_adamw_step_matches_reference(n, dims, case):
    """One ZeRO-1 AdamW step (moments and update on each rank's slice of the
    ZeRO-1 dim, the slices all-gathered) equals the JAX AdamW step on the
    whole gradients within 1e-6 of each leaf's peak (a weight near zero
    after the step is a difference of nearly equal terms, so its own
    relative error is float rounding), the norm within 1e-6; the moments
    held per rank shrink with the data-parallel degree."""
    _, cfg, jp, np_params = _model("olmoe")
    grads = _grads_like(np_params)
    new, _, jn = jadamw_update(jp, jax.tree.map(jnp.asarray, grads), jadamw_init(jp), lr=LR)
    new = jax.tree.map(np.asarray, new)
    new = {**{k: v for k, v in new.items() if k != "layers"},
           "layers": unstack_layers(cfg, new["layers"])}
    outs = _runs(n)
    total = sum(a.size for a in jax.tree.leaves(np_params))
    for out in outs:
        got = out[case + str(dims)]
        assert got["step"] == 1 and abs(got["gnorm"] - float(jn)) / float(jn) < ADAM_REL
        assert got["moment_elems"] < total / dims[1] * (1 + dims[0]) / (2 * dims[0]) + 1
    for path, v in outs[0][case + str(dims)]["params"].items():
        assert _rel(v, _at(new, path)) < ADAM_REL, path


@pytest.mark.parametrize("n,dims,case", _cases("decode"), ids=_ids)
def test_sharded_decode_steps_match_reference(n, dims, case):
    """``decode_step(ctx)`` from ``init_cache(ctx)`` (each rank's share of
    the KV heads or, when the model axis does not divide them, all of them;
    the SSM's heads and conv channels ``[xs share | B | C]``), one step per
    token: every step's logits within 1e-4 relative of the JAX
    ``decode_step`` from ``init_cache``."""
    name = case.split(":")[1]
    if ("decode", name) not in _WANT:
        jcfg, _, jp, _ = _model(name)
        toks = _tokens()[0][:, :DECODE]
        cache, want = JM.init_cache(jcfg, B, DECODE), []
        for t in range(DECODE):
            logits, cache = JM.decode_step(jcfg, jp, cache, jnp.asarray(toks[:, t]),
                                           jnp.int32(t))
            want.append(np.asarray(logits))
        _WANT[("decode", name)] = np.stack(want, axis=1)
    want = _WANT[("decode", name)]
    for out in _runs(n):
        assert _rel(out[case + str(dims)], want[_rows(dims, out)]) < REL


@pytest.mark.parametrize("n,dims,case", _cases("generate"), ids=_ids)
def test_sharded_greedy_generate_matches_reference(n, dims, case):
    """``greedy_generate(ctx)`` (sharded prefill, then sharded decode steps
    on each rank's cache share) gives the JAX ``greedy_generate``'s tokens
    on every rank's rows."""
    jcfg, _, jp, _ = _model("olmoe")
    prompt = _tokens()[0][:, :8]
    want = np.asarray(jgreedy(jcfg, jp, jnp.asarray(prompt), DECODE))
    for out in _runs(n):
        np.testing.assert_array_equal(out[case + str(dims)], want[_rows(dims, out)])


REFERENCE_MESH = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from dataclasses import replace
sys.path.insert(0, sys.argv[1])
from repro.configs import get_config
from repro.models import model as M
from repro.sharding.specs import ShardCtx, param_shardings
cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype="float32", capacity_factor=32.0)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ctx = ShardCtx(mesh, ("data",), "model", seq_shard=True)
params = M.init_params(cfg, jax.random.PRNGKey(0))
params = jax.device_put(params, param_shardings(ctx, params, zero1=True))
toks = jnp.asarray(np.load(sys.argv[2]))
logits, _, _ = M.forward(cfg, params, toks, ctx=ctx)
np.save(sys.argv[3], np.asarray(logits))
"""


def test_port_matches_reference_sharded_forward(tmp_path):
    """The reference's own sharded forward -- GSPMD over an Auto-axes (2, 2)
    mesh of 4 forced host devices, ``seq_shard``, parameters placed by
    ``param_shardings(zero1=True)`` -- against the port's (2, 2) forward
    with ``seq_shard`` on the same weights: within 1e-4 relative on every
    rank's rows."""
    toks = os.path.join(tmp_path, "tokens.npy")
    got = os.path.join(tmp_path, "logits.npy")
    np.save(toks, _tokens()[0])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", REFERENCE_MESH, os.path.join(ROOT, "src"), toks, got],
                   check=True, env=env, timeout=300)
    ref = np.load(got)
    assert _rel(ref, _want_forward("olmoe")[0]) < REL
    for out in _runs(4):
        assert _rel(out["forward:olmoe(2, 2)"]["logits"], ref[_rows((2, 2), out)]) < REL


def test_train_launcher_runs_on_ranks(capfd):
    """``launch/train.py --ranks 2 --device cpu``: a (1, 2) mesh by the
    reference's rule, seq_shard and ZeRO-1; the loss of its first step
    within bf16 rounding of the one-device launcher's."""
    args = ["--device", "cpu", "--arch", "olmoe-1b-7b", "--steps", "1", "--seq", "16"]
    sharded = train_launcher.main(args + ["--ranks", "2"])
    single = train_launcher.main(args)
    out = capfd.readouterr().out
    assert "2 ranks, mesh {'data': 1, 'model': 2}" in out
    assert len(sharded) == len(single) == 1
    assert all(np.isfinite(h["loss"]) for h in sharded)
    assert abs(sharded[0]["loss"] - single[0]["loss"]) < 0.02 * abs(single[0]["loss"])
