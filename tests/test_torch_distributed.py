"""The port's expert-parallel serving against the JAX package, on the CPU.

The reference's own mesh property (``tests/test_distributed.py``) fails on
this jax, so the oracle is the single-device path, which the reference's
a2a stage equals bit for bit whenever capacity admits every routed copy:
the port's a2a stage, run by gloo ranks in spawned processes
(``repro_torch.launch.mesh.spawn``, one spawn per world size, 2 and 4), is
held bit for bit to the port's single-device ``grouped_dispatch`` and within
1e-4 relative to the JAX ``_grouped_expert_module``; a whole ``Server`` on
those ranks gives the JAX single-device ``Server``'s tokens under both
schedulers and at one and two pipeline chunks.  The rank bodies live in
``tests/torch_ep_ranks.py``, which imports no JAX.  The helpers, the masked
arrival slots, the engine's construction errors and the launcher's
``--mesh`` run in this process (a one-rank gloo group where a group is
needed).
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.distributed import ep_engine as jep  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro.sharding.specs import ShardCtx as JShardCtx  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.distributed import ep_engine  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving.server import Request  # noqa: E402
from repro_torch.sharding.specs import ShardCtx  # noqa: E402

DECODE_LEN = 6
STAGE_T = 16
PLAN = dict(B=8, b_a=8, b_e=64, decode_chunk=4)
# the timed run's arrivals (s): two waves of four, 0.3 s apart
TIMED = [0.0] * 4 + [0.3] * 4
_MODEL: dict = {}
_RANKS: dict = {}


def _model():
    """Mixtral smoke in f32, the JAX weights bridged into the port, 8 ragged
    prompts (the static wave fills B = 8, which 2 and 4 divide) and the JAX
    single-device ``Server``'s tokens under both schedulers."""
    if not _MODEL:
        jcfg = replace(jget("mixtral-8x7b", smoke=True), dtype="float32")
        cfg = replace(get_config("mixtral-8x7b", smoke=True), dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, jp)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=int(s)).astype(np.int32)
                   for s in rng.integers(3, 17, size=8)]
        want = {}
        for sched in ("static", "continuous"):
            sv = JServer(jcfg, jp, JPlan(**PLAN),
                         JServeConfig(scheduler=sched, decode_len=DECODE_LEN))
            for p in prompts:
                sv.submit(JRequest(p, DECODE_LEN))
            want[sched] = [r.tokens.tolist() for r in sv.run().request_results]
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp, np_params=np_params, prompts=prompts,
                      want=want, tp=from_numpy_params(cfg, np_params, "cpu"))
    return _MODEL


def _ranks(n: int):
    """Every rank's results for world size ``n``: one spawn, cached."""
    if n not in _RANKS:
        m = _model()
        _RANKS[n] = mesh.spawn(
            ranks.serve_rank, n,
            (m["cfg"], m["np_params"], Plan(**PLAN), m["prompts"], DECODE_LEN, STAGE_T,
             TIMED),
            timeout_s=300.0, group_timeout_s=60.0)
    return _RANKS[n]


def _equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# In-process: helpers, masked slots, construction errors
# ---------------------------------------------------------------------------
def test_ep_helpers_match_reference():
    for t, req in [(8, 4), (8, 3), (7, 4), (8, 100), (1, 2), (12, 5)]:
        assert ep_engine.pipeline_chunks(t, req) == jep.pipeline_chunks(t, req)
    cfg, jcfg = get_config("mixtral-8x7b", smoke=True), jget("mixtral-8x7b", smoke=True)
    for T, n, item in [(8, 1, 4), (8, 2, 4), (8, 4, 4), (64, 2, 2), (6, 3, 2)]:
        assert (ep_engine.a2a_bytes_per_stage(cfg, T, n, item)
                == jep.a2a_bytes_per_stage(jcfg, T, n, item))
    assert ep_engine.validate_ep_shard(cfg, None) == jep.validate_ep_shard(jcfg, None) == 1
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh.group(1) as g:
        for disp in ("a2a", "psum", "grouped"):
            jctx = JShardCtx(mesh=jmesh, batch_axes=("data",), model_axis="model",
                             moe_dispatch=disp)
            got = []
            for fn, c, ctx in [(jep.validate_ep_shard, jcfg, jctx),
                               (ep_engine.validate_ep_shard, cfg,
                                ShardCtx(group=g, moe_dispatch=disp))]:
                try:
                    got.append(fn(c, ctx))
                except ValueError as err:
                    got.append(("ValueError", "moe_dispatch" in str(err)))
            assert got[0] == got[1], (disp, got)
    with pytest.raises(ValueError, match="process group"):
        ep_engine.validate_ep_shard(cfg, ShardCtx())


@pytest.mark.parametrize("n,E", [(1, 1), (40, 4), (64, 8), (300, 16)])
def test_masked_arrival_slots_match_reference(n, E):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, E, n)
    mask = rng.random(n) < 0.6
    want = np.asarray(jmoe._arrival_slots(jnp.asarray(ids), E, mask=jnp.asarray(mask)))
    got = moe._arrival_slots(torch.from_numpy(ids), E, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 64), (32, 64), (5, 1029), (1000, 3000), (0, 2500)])
def test_router_logits_do_not_depend_on_the_batch(lo, hi):
    """A row's router logits are the same bits inside any batch (products of
    ``ROUTER_ROWS`` rows), and within f32 rounding of one plain product and
    of the JAX router."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    whole = moe.router_logits(w, x)
    assert torch.equal(moe.router_logits(w, x[lo:hi]), whole[lo:hi])
    torch.testing.assert_close(whole, x.float() @ w, rtol=1e-5, atol=1e-5)
    jx = jnp.asarray(x[lo:hi].float().numpy())
    np.testing.assert_allclose(whole[lo:hi].numpy(), np.asarray(jx @ jnp.asarray(w.numpy())),
                               rtol=1e-5, atol=1e-5)


def test_engine_construction_errors():
    """The reference's construction checks, on a one-rank group; without
    one the loop expert path constructs (single-device only)."""
    m = _model()
    cfg, params, plan = m["cfg"], m["tp"], Plan(**PLAN)
    loop = ModuleBatchingEngine(cfg, params, plan, expert_path="loop", device="cpu")
    assert loop.sctx is None and loop.expert_path == "loop" and not loop.fused_eligible()
    with mesh.group(1) as g:
        sctx = ShardCtx(group=g)
        eng = ModuleBatchingEngine(cfg, params, plan, sctx=sctx, device="cpu")
        assert eng.sctx is sctx and not eng.fused_eligible()
        facade = ep_engine.ExpertParallelEngine(cfg, params, plan, sctx, ep_chunks=2,
                                                device="cpu")
        assert isinstance(facade, ModuleBatchingEngine) and facade.ep_chunks == 2
        with pytest.raises(ValueError, match="predict_topk"):
            ModuleBatchingEngine(cfg, params, replace(plan, predict_topk=2), sctx=sctx,
                                 device="cpu")
        with pytest.raises(ValueError, match="expert_path"):
            ModuleBatchingEngine(cfg, params, plan, sctx=sctx, expert_path="loop",
                                 device="cpu")
        with pytest.raises(ValueError, match="stream_weights"):
            ModuleBatchingEngine(cfg, params, plan, sctx=sctx, stream_weights=True,
                                 resident_bytes=0, device="cpu")
        from repro_torch.serving.weights import ParamStore

        store = ParamStore(cfg, params, resident_bytes=0, device="cpu")
        with pytest.raises(ValueError, match="fully resident"):
            ModuleBatchingEngine(cfg, None, plan, sctx=sctx, store=store, device="cpu")
        with pytest.raises(ValueError, match="moe_dispatch"):
            ModuleBatchingEngine(cfg, params, plan, device="cpu",
                                 sctx=ShardCtx(group=g, moe_dispatch="grouped"))
    with pytest.raises(ValueError, match="process group"):
        ep_engine.ExpertParallelEngine(cfg, params, plan, ShardCtx(), device="cpu")
    # no group: the single-device engine, fused decode and all
    assert ModuleBatchingEngine(cfg, params, plan, sctx=ShardCtx(),
                                device="cpu").fused_eligible()


def test_one_rank_group_serves_the_single_device_tokens():
    """A one-rank group runs the single-device stage: the JAX tokens, no
    bytes, no clock broadcasts, one collective dispatch per MoE layer and
    decode tick."""
    m = _model()
    with mesh.group(1) as g:
        got = ranks.serve(m["cfg"], m["tp"], Plan(**PLAN),
                          [Request(p, DECODE_LEN) for p in m["prompts"]],
                          "static", ShardCtx(group=g))
    assert got["tokens"] == m["want"]["static"]
    assert got["a2a_bytes"] == 0 and got["clock_broadcasts"] == 0
    assert got["collective_dispatches"] == m["cfg"].num_layers * got["decode_slot_steps"] // 8


@pytest.mark.parametrize("grid", ["2,1", "1,2"])
def test_launcher_mesh_smoke(grid, capsys):
    """``--mesh DP,EP`` on the CPU: DP replicas behind one queue, or EP
    spawned gloo ranks that serve the same tokens."""
    from repro_torch.launch.serve import main

    main(["--smoke", "--device", "cpu", "--mesh", grid, "--requests", "4", "--batch", "4",
          "--decode-len", "3", "--prompt-lens", "5,9", "--omega", "0"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    dp, ep = (int(x) for x in grid.split(","))
    assert out.count("replica[") == (dp if dp > 1 else 0)
    assert ("expert-parallel:" in out) == (ep > 1)


# ---------------------------------------------------------------------------
# Spawned gloo ranks: the stage
# ---------------------------------------------------------------------------
WORLD = [2, 4]


@pytest.mark.parametrize("n", WORLD)
def test_a2a_stage_bit_identical_to_single_device(n):
    """Capacity admits every copy: (y, kept, dropped, load) of the a2a stage
    equal the port's grouped_dispatch bit for bit on every rank, one chunk
    and two, pipelined and serial; 2c + 1 planned staging reads; within
    1e-4 relative of the JAX grouped module."""
    res = _ranks(n)
    m = _model()
    single = res[0]["stage"][f"single_{STAGE_T}"]
    a = ranks.stage_inputs(m["cfg"], STAGE_T)
    p = {"norm2": jnp.asarray(a["norm2"]),
         "moe": {"router": jnp.asarray(a["router"]), "experts_w_gate": jnp.asarray(a["wg"]),
                 "experts_w_up": jnp.asarray(a["wu"]), "experts_w_down": jnp.asarray(a["wd"])}}
    jy = np.asarray(jengine._grouped_expert_module(m["jcfg"], p, jnp.asarray(a["x"]),
                                                   STAGE_T)[0])
    for case, chunks in [("a2a_1", 1), ("a2a_2", 2), ("a2a_2_serial", 2)]:
        for r in res:
            got = r["stage"][case]
            assert _equal(got[:4], single), (n, case)
            assert got[4] == 2 * chunks + 1
        assert int(single[2]) == 0
    err = np.abs(res[0]["stage"]["a2a_1"][0] - jy).max() / np.abs(jy).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("n", WORLD)
def test_a2a_stage_under_capacity_pressure_counts_exactly(n):
    res = _ranks(n)
    T, k = STAGE_T, _model()["cfg"].experts_per_token
    single = res[0]["stage"][f"single_{ranks.CAPACITY_PRESSURE}"]
    y, kept, dropped, load, _ = res[0]["stage"]["a2a_pressure"]
    assert int(dropped) > 0 and int(kept) + int(dropped) == T * k
    assert int(kept) == int(single[1])
    np.testing.assert_array_equal(load, single[3])


@pytest.mark.parametrize("n", WORLD)
def test_psum_stage_allclose_to_single_device(n):
    res = _ranks(n)
    single = res[0]["stage"][f"single_{STAGE_T}"]
    for r in res:
        y, kept, dropped, load, reads = r["stage"]["psum"]
        np.testing.assert_allclose(y, single[0], rtol=1e-5, atol=1e-6)
        assert _equal([kept, dropped, load], single[1:]) and reads == 1
    res_p = res[0]["stage"][f"single_{ranks.CAPACITY_PRESSURE}"]
    assert int(res_p[2]) > 0          # the pressure case drops on one device


@pytest.mark.parametrize("n", WORLD)
def test_indivisible_batch_takes_the_single_device_stage(n):
    """T % n != 0 runs the single-device stage (no bytes); experts that the
    group does not divide fail the construction check."""
    for r in _ranks(n):
        fb = dict(r["fallback"])
        assert "not divisible by the group size" in fb.pop("error")
        assert fb == {"equal": True, "a2a_bytes": 0, "collective_dispatches": 1}


# ---------------------------------------------------------------------------
# Spawned gloo ranks: whole servers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("sched", ["static", "continuous"])
@pytest.mark.parametrize("n", WORLD)
def test_ep_server_gives_the_reference_tokens(n, sched, chunks):
    """Every rank's tokens are the JAX single-device Server's; a2a bytes are
    the per-stage bytes times the stages, one stage per MoE layer and decode
    tick, every tick per module; nothing dropped."""
    m = _model()
    cfg = m["cfg"]
    for r in _ranks(n):
        got = r[f"{sched}_{chunks}"]
        ticks = got["decode_slot_steps"] // PLAN["B"]
        assert got["tokens"] == m["want"][sched]
        assert got["collective_dispatches"] == cfg.num_layers * ticks > 0
        assert got["a2a_bytes"] == got["collective_dispatches"] * ep_engine.a2a_bytes_per_stage(
            cfg, PLAN["B"], n, 4) > 0
        assert got["fused_ticks"] == 0 and got["dropped"] == 0


@pytest.mark.parametrize("n", WORLD)
def test_serial_equals_pipelined_and_psum_serves(n):
    m = _model()
    for r in _ranks(n):
        assert r["static_2_serial"]["tokens"] == r["static_2"]["tokens"]
        assert r["psum"]["tokens"] == m["want"]["static"]
        assert r["psum"]["a2a_bytes"] == 0 and r["psum"]["collective_dispatches"] > 0


@pytest.mark.parametrize("n", WORLD)
def test_strict_sanitizer_serve_counts_the_planned_exchanges(n):
    """Under the strict sanitizer every staging read is in an ``ep-a2a-*``
    scope (an unplanned read raises): per stage of two chunks, two batch
    reads and three combine reads; one clock broadcast a step."""
    for r in _ranks(n):
        planned, got = r["strict_planned"], r["strict"]
        stages = got["collective_dispatches"]
        assert planned["ep-a2a-batch"] == 2 * stages
        assert planned["ep-a2a-combine"] == 3 * stages
        assert planned["ep-clock"] == got["clock_broadcasts"] > 0
        assert got["tokens"] == _model()["want"]["static"]


def test_timed_arrivals_agree_across_ranks():
    """Arrivals 0.3 s apart: rank 0's clock decides every rank's admissions,
    so the ranks admit the same waves and serve the same tokens (a rank that
    diverged would stall its collectives into the group timeout)."""
    res = _ranks(2)
    runs = [r["timed"] for r in res]
    assert all(t["waves"] == runs[0]["waves"] and t["tokens"] == runs[0]["tokens"]
               for t in runs)
    assert len(runs[0]["tokens"]) == len(TIMED) and len(runs[0]["waves"]) >= 2
    assert runs[0]["clock_broadcasts"] > 0
