"""The port's ``ReplicaServer`` against the JAX package's, on the CPU in f32.

N ``Server`` replicas behind one arrival queue: both routing policies give
the JAX fleet's tokens, submission-order indices, per-replica request
counts and merged counters (work counters summed, phase times the slowest
replica's); a callable policy routes, an unknown one is refused; a shared
``PrefixStore`` gives the JAX fleet's merged hits and misses; a killed
replica fails over onto the survivor with one fault-free ``Server``'s
tokens (the reference's ``tests/test_faults.py::test_replica_kill_*``), and
a replica whose step raises a ``FaultError`` is declared dead while any
other exception propagates.  Fault-free baselines run under
``faults.shielded()``.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.faults as jfaults  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.distributed import ReplicaServer as JReplicaServer  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.distributed import ReplicaServer  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

PLAN = dict(B=8, b_a=8, b_e=64, decode_chunk=4)
_MODEL: dict = {}


def _model():
    """Mixtral smoke in f32 (the reference tests' model), the JAX weights
    bridged into the port."""
    if not _MODEL:
        jcfg = replace(jget("mixtral-8x7b", smoke=True), dtype="float32")
        cfg = replace(get_config("mixtral-8x7b", smoke=True), dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp,
                      tp=from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _MODEL


def _requests(vocab, n=6, seed=0, shared=0, lens=(3, 12)):
    """The reference tests' ragged requests (prompts of ``lens`` 3..11
    tokens, decode 2..6), optionally behind ``shared`` common tokens:
    (prompt, decode_len)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, size=shared)
    out = []
    for _ in range(n):
        p = rng.integers(1, vocab, size=int(rng.integers(*lens)))
        out.append((np.concatenate([head, p]).astype(np.int32), int(rng.integers(2, 7))))
    return out


def _tokens(report):
    return [list(map(int, r.tokens)) for r in report.request_results]


def _fleet(kind, n, reqs, policy="least-loaded", plan=PLAN, **serve_kw):
    """A JAX (``kind`` 'jax') or port fleet of ``n`` replicas, ``reqs``
    submitted and run: the ``ReplicaReport``."""
    m = _model()
    if kind == "jax":
        rs = JReplicaServer(m["jcfg"], m["jp"], n, plan=JPlan(**plan),
                            serve=JServeConfig(**serve_kw), policy=policy)
        req = JRequest
    else:
        rs = ReplicaServer(m["cfg"], m["tp"], n, plan=Plan(**plan),
                           serve=ServeConfig(**serve_kw), policy=policy, device="cpu")
        req = Request
    for p, d in reqs:
        rs.submit(req(p, d))
    return rs.run()


MERGED_SUMS = ("decode_slot_steps", "wasted_slot_steps", "prefill_tokens",
               "expert_tokens_dropped", "admission_deferrals", "a2a_bytes",
               "collective_dispatches", "failovers", "requeued_requests")


@pytest.mark.parametrize("policy", ["round-robin", "least-loaded"])
def test_replica_server_matches_reference_fleet(policy):
    """Tokens, submission-order indices, per-replica request counts and the
    merged counters equal the JAX fleet's, and the fleet drains like one
    JAX ``Server``; work counters sum, phase times are the slowest
    replica's."""
    m = _model()
    reqs = _requests(m["cfg"].vocab_size)
    kw = dict(scheduler="static")
    got = _fleet("torch", 2, reqs, policy, **kw)
    want = _fleet("jax", 2, [(p.tolist(), d) for p, d in reqs], policy, **kw)
    one = JServer(m["jcfg"], m["jp"], JPlan(**PLAN), JServeConfig(**kw))
    for p, d in reqs:
        one.submit(JRequest(p.tolist(), d))
    assert _tokens(got.merged) == _tokens(want.merged) == _tokens(one.run())
    assert [r.index for r in got.merged.request_results] == list(range(len(reqs)))
    assert ([len(r.request_results) for r in got.per_replica]
            == [len(r.request_results) for r in want.per_replica])
    for name in MERGED_SUMS:
        assert getattr(got.merged, name) == getattr(want.merged, name), name
        assert getattr(got.merged, name) == sum(getattr(r, name) for r in got.per_replica)
    assert got.merged.decode_s == max(r.decode_s for r in got.per_replica)
    assert got.merged.prefill_s == max(r.prefill_s for r in got.per_replica)
    np.testing.assert_array_equal(got.merged.expert_load, want.merged.expert_load)


def test_replica_server_custom_policy_and_errors():
    m = _model()
    with pytest.raises(ValueError, match="routing policy"):
        ReplicaServer(m["cfg"], m["tp"], 2, plan=Plan(**PLAN), policy="zigzag", device="cpu")
    rep = _fleet("torch", 2, _requests(m["cfg"].vocab_size, n=3), lambda servers, req: 1,
                 scheduler="static")
    assert [len(r.request_results) for r in rep.per_replica] == [0, 3]


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_shared_prefix_store_matches_reference(scheduler):
    """Paging and the prefix cache: six prompts of a shared 9-token span and
    1..6 tokens of their own (each keyed at pspan 8 of 8-token pages); the
    replicas share one ``PrefixStore``, so a prefix stored by one is a hit
    on the other; the merged hits, misses and tokens equal the JAX
    fleet's."""
    m = _model()
    reqs = _requests(m["cfg"].vocab_size, n=6, seed=2, shared=9, lens=(1, 7))
    kw = dict(scheduler=scheduler, kv_page_tokens=8, prefix_cache=True, decode_len=6,
              max_seq=24)
    plan = dict(B=2, b_a=2, b_e=16, omega=0.0)
    got = _fleet("torch", 2, reqs, "round-robin", plan, **kw)
    want = _fleet("jax", 2, [(p.tolist(), d) for p, d in reqs], "round-robin", plan, **kw)
    assert _tokens(got.merged) == _tokens(want.merged)
    assert (got.merged.prefix_hits, got.merged.prefix_misses) == (
        want.merged.prefix_hits, want.merged.prefix_misses)
    assert got.merged.prefix_hits > 0
    assert got.merged.prefill_tokens == want.merged.prefill_tokens


def _kill_prompts(cfg, n):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, cfg.vocab_size, 8))) for _ in range(n)]


def test_replica_kill_fails_over_token_identical():
    """The failover contract (the reference's test): a replica killed
    mid-drain loses its KV, its unfinished requests resubmit onto the
    survivor, and the merged drain is token-identical to one fault-free
    ``Server`` (the port's and the JAX one's)."""
    m = _model()
    cfg, plan = m["cfg"], dict(B=4, b_a=2, b_e=64, omega=0.0, decode_chunk=1)
    prompts = _kill_prompts(cfg, 6)
    with faults.shielded(), jfaults.shielded():
        srv = Server(cfg, m["tp"], Plan(**plan),
                     serve=ServeConfig(scheduler="continuous", decode_len=6), device="cpu")
        for p in prompts:
            srv.submit(Request(p, 6))
        want = _tokens(srv.run())
        kw = dict(scheduler="continuous", decode_len=6, faults="seed=1,kill=1@3")
        rrep = _fleet("torch", 2, [(p, 6) for p in prompts], "round-robin", plan, **kw)
        jrep = _fleet("jax", 2, [(p, 6) for p in prompts], "round-robin", plan, **kw)
    merged = rrep.merged
    assert _tokens(merged) == want == _tokens(jrep.merged)
    assert merged.failovers == 1 == jrep.merged.failovers
    assert merged.requeued_requests == jrep.merged.requeued_requests > 0
    assert len(merged.request_results) == len(prompts)


def test_replica_kill_with_no_survivors_fails_loudly():
    m = _model()
    with faults.shielded():
        rs = ReplicaServer(m["cfg"], m["tp"], 1, plan=Plan(B=2, b_a=2, b_e=16, omega=0.0,
                                                              decode_chunk=1),
                           serve=ServeConfig(scheduler="continuous", decode_len=4,
                                             faults="seed=0,kill=0@1"), device="cpu")
        rs.submit(Request(_kill_prompts(m["cfg"], 1)[0], 4))
        with pytest.raises(faults.FaultError, match="no survivors"):
            rs.run()


@pytest.mark.parametrize("error,dead", [(faults.StreamTimeoutError, True),
                                        (RuntimeError, False)])
def test_a_fault_error_kills_the_replica_other_errors_propagate(error, dead):
    """Recovery exhausted (a ``FaultError`` out of a replica's step) fails
    the replica over; any other exception is a bug and aborts the run."""
    m = _model()
    reqs = _requests(m["cfg"].vocab_size, n=4)
    rs = ReplicaServer(m["cfg"], m["tp"], 2, plan=Plan(**PLAN),
                       serve=ServeConfig(scheduler="static"), policy="round-robin",
                       device="cpu")
    for p, d in reqs:
        rs.submit(Request(p, d))

    def broken():
        raise error("injected by the test")

    rs.servers[1].step = broken
    if not dead:
        with pytest.raises(RuntimeError, match="injected"):
            rs.run()
        return
    rep = rs.run()
    one = Server(m["cfg"], m["tp"], Plan(**PLAN), serve=ServeConfig(scheduler="static"),
                 device="cpu")
    for p, d in reqs:
        one.submit(Request(p, d))
    assert _tokens(rep.merged) == _tokens(one.run())
    assert rep.merged.failovers == 1 and rep.merged.requeued_requests == 2
