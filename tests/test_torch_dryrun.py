"""The port's dry run (``repro_torch.launch.dryrun``): one rank of a mesh on
fake tensors over a fake process group.

* Smoke cases run: olmoe, mixtral, qwen2, mamba2 and jamba smoke configs,
  each kind (train, prefill, decode) on meshes (1, 1), (1, 2) and (2, 2).
* The dry run equals a real run: 4 gloo CPU ranks on (2, 2) run the same
  train, prefill and decode steps on real tensors (``launch.mesh.spawn``,
  the rank body in ``tests/torch_sharded_ranks.py``); each rank's
  collectives by kind (counts and sent bytes) and the bytes it holds equal
  the dry run's exactly.
* FLOPs against the reference: at (1, 1), 2 x 64, the port's matmul FLOPs
  of ``prefill`` against ``repro.launch.hlo_analysis.dot_flops`` of the
  reference's jitted ``prefill`` (trip count ``num_groups``).
* One production-mesh case at full size (olmoe-1b-7b ``decode_32k``, single
  pod), the skip reasons, and no process group left behind.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402

NAMES = ("data", "model")
B, S = 4, 16
SMOKE = ("olmoe-1b-7b", "mixtral-8x7b", "qwen2-1.5b", "mamba2-370m", "jamba-1.5-large-398b")
MESHES = ((1, 1), (1, 2), (2, 2))
KINDS = ("train", "prefill", "decode")


def _shape(kind, b=B, s=S):
    return ShapeSpec(kind, kind, s, b)


def _case(arch, kind, dims, cfg=None, shape=None, **kw):
    return dryrun.run_case(arch, kind, False, save=False, cfg=cfg or get_config(arch, smoke=True),
                           shape=shape or _shape(kind), mesh_dims=(dims, NAMES), **kw)


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_cases_run(arch):
    """Every kind on every mesh ends ok, with FLOPs, memory and (on more than
    one rank) collectives; the group is gone after each case."""
    for kind in KINDS:
        for dims in MESHES:
            r = _case(arch, kind, dims, trace=False)
            assert r["status"] == "ok", (kind, dims, r.get("traceback"))
            assert not dist.is_initialized()
            mem = r["memory"]
            assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] >= 0
            assert mem["peak_size_in_bytes"] == (mem["argument_size_in_bytes"]
                                                 + mem["temp_size_in_bytes"])
            assert r["dot_flops_per_device"] > 0 and r["n_devices"] == dims[0] * dims[1]
            assert bool(r["collectives"]) == (dims != (1, 1)), (kind, dims)


def test_dryrun_equals_a_real_four_rank_run():
    """Train, prefill and decode on (2, 2), OLMoE smoke: every rank's
    collectives by kind (counts, sent bytes) and argument bytes equal the
    dry run's rank 0 exactly."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    cases = [(kind, cfg, _shape(kind), (2, 2), "fsdp") for kind in KINDS]
    real = mesh.spawn(ranks.dryrun_rank, 4, (cases,), timeout_s=600.0, group_timeout_s=120.0)
    for kind in KINDS:
        want = _case("olmoe-1b-7b", kind, (2, 2), cfg=cfg, trace=False)
        by_kind = {k: {"calls": v["count"], "bytes": v["sent_bytes"]}
                   for k, v in want["collectives"].items()}
        for r, out in enumerate(real):
            assert out[kind]["by_kind"] == by_kind, (kind, r)
            assert out[kind]["arg_bytes"] == want["memory"]["argument_size_in_bytes"], (kind, r)


def test_tp_weights_keep_the_optimizer_state_whole():
    """``weights="tp"``: no ZeRO-1 split of the parameters or their state,
    so more held per rank and no all-gather over the batch axes."""
    fsdp = _case("olmoe-1b-7b", "train", (2, 2), trace=False)
    tp = _case("olmoe-1b-7b", "train", (2, 2), weights="tp", trace=True)
    assert tp["memory"]["argument_size_in_bytes"] > fsdp["memory"]["argument_size_in_bytes"]
    assert not any(r["type"] == "collective" and r["kind"] == "all-gather"
                   and r["axes"] == ["data"] for r in tp["trace"])


def _reference_prefill_dot_flops(arch, b, s):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.launch import hlo_analysis
    from repro.models import model as JM

    cfg = jget(arch, smoke=True)
    params = jax.eval_shape(lambda k: JM.init_params(cfg, k), jax.random.PRNGKey(0))
    tokens = jax.ShapeDtypeStruct((b, s), jnp.int32)
    hlo = jax.jit(lambda p, t: JM.prefill(cfg, p, t)).lower(params, tokens).compile().as_text()
    return hlo_analysis.dot_flops(hlo, JM.num_groups(cfg))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "mixtral-8x7b"])
def test_prefill_flops_equal_the_reference(arch):
    """At (1, 1), 2 x 64 tokens.  qwen2 (dense): equal.  olmoe, mixtral
    (MoE): the port's router (``models/moe.py::router_logits``) multiplies
    zero-padded blocks of ``ROUTER_ROWS`` = 1024 rows so that a row's
    logits do not depend on the batch; that adds 2 (ceil(T/1024) 1024 - T)
    D E FLOPs for each MoE layer over the reference's (T x D) @ (D x E),
    and nothing else differs: equal after subtracting it."""
    from repro_torch.models.moe import ROUTER_ROWS

    b, s = 2, 64
    cfg = get_config(arch, smoke=True)
    got = _case(arch, "prefill", (1, 1), shape=_shape("prefill", b, s),
                trace=False)["dot_flops_per_device"]
    T = b * s
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))
    pad = 2 * (-(-T // ROUTER_ROWS) * ROUTER_ROWS - T) * cfg.d_model * cfg.num_experts
    assert got - n_moe * pad == _reference_prefill_dot_flops(arch, b, s)


def test_production_case_at_full_size():
    """olmoe-1b-7b ``decode_32k`` on rank 0 of the single pod (16 x 16):
    8 rows of a 32768-slot cache, heads and experts over 16 model ranks."""
    r = dryrun.run_case("olmoe-1b-7b", "decode_32k", False, save=False, trace=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_devices"] == 256 and r["mesh_dims"] == {"data": 16, "model": 16}
    cfg = get_config("olmoe-1b-7b")
    rows = SHAPES["decode_32k"].global_batch // 16
    kv = 2 * cfg.num_layers * rows * 32768 * (cfg.num_kv_heads // 16) * cfg.head_dim * 2
    assert r["memory"]["argument_size_in_bytes"] > kv
    assert r["collectives"]["all-reduce"]["count"] > 0
    assert not dist.is_initialized()


def test_production_decode_splits_the_cache_span():
    """qwen1.5-4b ``decode_32k`` on rank 0 of the single pod: 20 KV heads,
    which the 16-way model axis does not divide, so the rank holds a
    sixteenth of the span of its 8 rows, 6,710,886,400 bytes of KV cache
    (40 layers x 8 x 2048 x 20 x 128 x 2 B, K and V), as
    ``cache_shardings`` gives it, and both building its arguments and its
    step peak below the card's 80 GB (the cache is allocated at the share's
    shape, never whole)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import trace_analysis

    cfg, shape = get_config("qwen1.5-4b"), SHAPES["decode_32k"]
    prod = mesh.make_production_mesh()
    with dryrun.rank_of(prod.dims, prod.axis_names) as m, FakeTensorMode():
        _, args, _ = dryrun.build_case(cfg, shape, mesh.make_ctx(m), "fsdp")
        cache_bytes = trace_analysis.storage_bytes(args["cache"])
        spans = {c["k"].shape[1] for c in args["cache"]}
    assert cache_bytes == 6_710_886_400 and spans == {2048}
    r = dryrun.run_case("qwen1.5-4b", "decode_32k", False, save=False, trace=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["memory"]["peak_size_in_bytes"] < 80e9
    assert r["memory"]["build_peak_size_in_bytes"] < 80e9
    assert not dist.is_initialized()


def test_skip_reasons_equal_the_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch.dryrun import skip_reason as jskip

    for arch in list_archs():
        for name in SHAPES:
            assert dryrun.skip_reason(get_config(arch), SHAPES[name]) == \
                jskip(jget(arch), JSHAPES[name]), (arch, name)
    r = dryrun.run_case("olmoe-1b-7b", "long_500k", False, save=False)
    assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]


def test_an_undivided_batch_is_replicated():
    """4 rows on 3 data ranks: every data rank holds the whole batch (the
    reference's spec drops a split the batch does not divide)."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    r = _case("olmoe-1b-7b", "prefill", (3, 1), cfg=cfg, trace=False)
    whole = _case("olmoe-1b-7b", "prefill", (1, 1), cfg=cfg, trace=False)
    assert r["status"] == "ok" and r["batch_replicated"]
    assert r["dot_flops_per_device"] == whole["dot_flops_per_device"]


def test_a_failure_is_reported_and_the_group_released(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no step")

    monkeypatch.setattr(dryrun, "build_case", broken)
    bad = _case("olmoe-1b-7b", "prefill", (1, 2))
    assert bad["status"] == "failed" and bad["error"] == "RuntimeError: no step"
    assert "no step" in bad["traceback"]
    assert not dist.is_initialized()


def test_fake_group_refuses_a_process_with_a_group():
    with mesh.fake_group(4):
        with pytest.raises(RuntimeError, match="default process group"):
            with mesh.fake_group(2):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
