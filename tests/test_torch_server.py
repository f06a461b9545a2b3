"""Port ``Server`` vs the JAX ``Server`` on the CPU, in f32: static and
continuous scheduling over ragged prompts give the same per-request tokens
and the same slot accounting."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.core.hardware import HardwareProfile as JHardware  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.hardware import HardwareProfile  # noqa: E402
from repro_torch.data.datasets import DatasetSpec, synthetic_requests  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

LENS = [12, 5, 9, 3, 7, 12, 4]
DECS = [4, 6, 3, 5, 4, 2, 6]


def _setup(arch="olmoe-1b-7b"):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    return jcfg, cfg, jp, tp, prompts


def _serve(server, requests):
    for r in requests:
        server.submit(r)
    return server.run()


# mamba2: every wave the JAX server pads must be one its ssd_scan accepts
# (longest prompt <= the 32-position smoke chunk or a multiple of it)
SSM_LENS = [12, 32, 64, 5, 30, 64, 9]


@pytest.mark.parametrize("arch,scheduler", [
    pytest.param("olmoe-1b-7b", "static", id="static"),
    pytest.param("olmoe-1b-7b", "continuous", id="continuous"),
    pytest.param("mamba2-370m", "static", id="mamba2-370m-static"),
    pytest.param("mamba2-370m", "continuous", id="mamba2-370m-continuous"),
])
def test_server_matches_jax_server(arch, scheduler):
    jcfg, cfg, jp, tp, prompts = _setup(arch)
    if arch == "mamba2-370m":
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SSM_LENS]
    kw = dict(B=3, b_a=2, b_e=3, omega=0.0)          # b_e = B: no drops
    jrep = _serve(JServer(jcfg, jp, JPlan(**kw),
                          serve=JServeConfig(scheduler=scheduler, decode_len=4)),
                  [JRequest(p, d) for p, d in zip(prompts, DECS)])
    trep = _serve(Server(cfg, tp, Plan(**kw),
                         serve=ServeConfig(scheduler=scheduler, decode_len=4),
                         device="cpu"),
                  [Request(p, d) for p, d in zip(prompts, DECS)])
    assert len(trep.request_results) == len(prompts)
    for a, b in zip(jrep.request_results, trep.request_results):
        assert a.index == b.index
        assert np.array_equal(a.tokens, b.tokens)
        assert a.decode_steps == b.decode_steps
    assert trep.decode_slot_steps == jrep.decode_slot_steps
    assert trep.wasted_slot_steps == jrep.wasted_slot_steps
    assert trep.admission_deferrals == jrep.admission_deferrals
    assert trep.expert_tokens_dropped == jrep.expert_tokens_dropped == 0
    assert np.array_equal(trep.expert_load, jrep.expert_load)


def test_finished_server_frees_its_cache_without_gc():
    """A handle holds its Server weakly: after ``run()``, ``del server``
    alone (the cycle collector off) frees the engine's cache, and a
    finished handle still gives its tokens and ``result()``; an unfinished
    handle whose server is gone raises from ``stream()``."""
    import gc
    import weakref

    _, cfg, _, tp, prompts = _setup()
    plan = Plan(B=3, b_a=2, b_e=3, omega=0.0)
    gc.collect()
    gc.disable()
    try:
        server = Server(cfg, tp, plan, serve=ServeConfig(decode_len=4), device="cpu")
        handles = [server.submit(Request(p, d)) for p, d in zip(prompts, DECS)]
        server.run()
        cache = weakref.ref(server._engine.cache[0]["k"])
        del server
        assert cache() is None
        assert all(h.finished for h in handles)
        assert handles[0].result().tokens.tolist() == handles[0].tokens
        assert list(handles[1].stream()) == handles[1].tokens
        server = Server(cfg, tp, plan, serve=ServeConfig(decode_len=4), device="cpu")
        queued = server.submit(Request(prompts[0], 4))
        del server
        with pytest.raises(RuntimeError, match="Server is gone"):
            next(queued.stream())
    finally:
        gc.enable()


def test_continuous_admission_deferrals_match():
    """Eq. 2 gated admission: a host budget of 1.5 longest sequences
    defers the queue head the same number of times on both sides."""
    jcfg, cfg, jp, tp, prompts = _setup()
    need = W.kv_bytes_per_seq(cfg, max(LENS) + max(DECS))
    host = W.model_bytes(cfg) + 1.5 * need
    fields = dict(name="tiny", device_flops=1e12, device_mem_bw=1e11,
                  device_mem_bytes=1e9, saturation_tokens=64,
                  host_mem_bytes=host, cpu_flops=1e11, cpu_mem_bw=1e10)
    kw = dict(B=3, b_a=3, b_e=3, omega=0.0)
    jrep = _serve(JServer(jcfg, jp, JPlan(**kw), serve=JServeConfig(
        scheduler="continuous", decode_len=4, hw=JHardware(**fields))),
        [JRequest(p, d) for p, d in zip(prompts, DECS)])
    trep = _serve(Server(cfg, tp, Plan(**kw), serve=ServeConfig(
        scheduler="continuous", decode_len=4, hw=HardwareProfile(**fields)),
        device="cpu"), [Request(p, d) for p, d in zip(prompts, DECS)])
    assert trep.admission_deferrals == jrep.admission_deferrals > 0
    for a, b in zip(jrep.request_results, trep.request_results):
        assert np.array_equal(a.tokens, b.tokens)
    assert trep.decode_slot_steps == jrep.decode_slot_steps


def test_schedulers_agree_and_stream_tokens():
    _, cfg, _, tp, prompts = _setup("mixtral-8x7b")
    plan = Plan(B=3, b_a=3, b_e=3, omega=0.0)
    reps, seen = {}, []
    for sched in ("static", "continuous"):
        server = Server(cfg, tp, plan, serve=ServeConfig(scheduler=sched,
                                                         decode_len=4),
                        device="cpu")
        handles = [server.submit(Request(p, d),
                                 on_token=lambda h, t: seen.append((h.index, t)))
                   for p, d in zip(prompts, DECS)]
        reps[sched] = server.run()
        assert all(h.finished for h in handles)
        for h, r in zip(handles, reps[sched].request_results):
            assert h.tokens == r.tokens.tolist()
            assert len(h.tokens) == DECS[h.index]
    for a, b in zip(reps["static"].request_results,
                    reps["continuous"].request_results):
        assert np.array_equal(a.tokens, b.tokens)


def test_synthetic_requests_and_validation():
    _, cfg, _, tp, _ = _setup()
    reqs = synthetic_requests(DatasetSpec("t", 4, 8, 3), cfg.vocab_size,
                              prompt_lens=[8, 5], arrivals=[0, 0, 0.01, 0.02])
    assert [len(r.prompt) for r in reqs] == [8, 5, 8, 5]
    assert reqs[3].arrival_s == 0.02
    server = Server(cfg, tp, Plan(B=2, b_a=2, b_e=2),
                    serve=ServeConfig(max_seq=10), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        server.submit(Request(np.zeros(9, np.int32), 4))
    # the reference's rules: a prefix cache needs paging; re-planning and
    # fault injection are knobs
    assert ServeConfig(kv_page_tokens=16, prefix_cache=True).prefix_cache
    with pytest.raises(AssertionError, match="paging"):
        ServeConfig(prefix_cache=True)
    assert ServeConfig(replan_skew=2.0).replan_skew == 2.0
    assert ServeConfig(faults="seed=0").faults == "seed=0"
