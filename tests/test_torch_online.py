"""The serving entry point's traffic options against the JAX package, on the
CPU in f32: EOS (tokens and slot accounting under both schedulers),
open-loop arrivals, the launcher's request builder against the reference
launcher's construction, the sampling helpers, the one-device capacity
oracle and the report's means; then the launcher itself on the smoke
config."""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import io  # noqa: E402
from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.core.hardware import HardwareProfile as JHardware  # noqa: E402
from repro.data.datasets import DatasetSpec as JDatasetSpec  # noqa: E402
from repro.data.datasets import synthetic_requests as jsynthetic_requests  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import RequestResult as JRequestResult  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import ServeReport as JServeReport  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch.bridge import from_numpy_params, to_tensor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.hardware import HardwareProfile  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import prng, sampling  # noqa: E402
from repro_torch.serving.scheduler import serve_dataset  # noqa: E402
from repro_torch.serving.server import Request, RequestResult, ServeConfig, ServeReport  # noqa: E402
from repro_torch.serving.server import Server  # noqa: E402

LENS = [12, 5, 9, 3, 7, 12]
DECS = [7, 9, 4, 8, 6, 9]
KW = dict(B=3, b_a=3, b_e=3, omega=0.0)          # b_e = B: no drops


def _setup(arch):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    return jcfg, cfg, jp, tp, prompts


def _serve(server, requests):
    for r in requests:
        server.submit(r)
    return server.run()


@pytest.fixture(scope="module")
def smoke():
    """``smoke(arch)``: ``_setup(arch)`` and the EOS id -- the token most
    frequent in a JAX static run without EOS, each request's last token
    aside (the schedulers give the same tokens without EOS) -- made once
    per arch for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, cfg, jp, tp, prompts = _setup(arch)
            plain = _serve(JServer(jcfg, jp, JPlan(**KW), serve=JServeConfig(decode_len=4)),
                           [JRequest(p, d) for p, d in zip(prompts, DECS)])
            flat = np.concatenate([r.tokens[:-1] for r in plain.request_results])
            made[arch] = (jcfg, cfg, jp, tp, prompts, int(np.bincount(flat).argmax()))
        return made[arch]
    return get


def _tight_hw(cfg, cls):
    """A host with room for the weights and 1.5 of the longest sequences'
    KV: Eq. 2 defers admissions under the continuous scheduler."""
    need = W.kv_bytes_per_seq(cfg, max(LENS) + max(DECS))
    return cls(name="tight", device_flops=1e12, device_mem_bw=1e11, device_mem_bytes=1e9,
               saturation_tokens=64, host_mem_bytes=W.model_bytes(cfg) + 1.5 * need,
               cpu_flops=1e11, cpu_mem_bw=1e10)


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_eos_matches_jax_server(smoke, arch, scheduler):
    """EOS, taken as the most frequent token of a no-EOS run, finishes some
    requests early; per-request tokens, ``decode_steps`` and the slot
    accounting equal the JAX ``Server``'s, through ``serve_dataset`` (with
    ``eos_id``, per-request decode lengths and, continuous, the Eq. 2 gate
    ``hw``) and through a ``Server`` at ``decode_chunk`` 1 and 8 alike."""
    jcfg, cfg, jp, tp, prompts, eos = smoke(arch)
    continuous = scheduler == "continuous"
    jhw = _tight_hw(cfg, JHardware) if continuous else None
    want = _serve(JServer(jcfg, jp, JPlan(**KW), serve=JServeConfig(
        scheduler=scheduler, decode_len=4, eos_id=eos, hw=jhw)),
        [JRequest(p, d) for p, d in zip(prompts, DECS)])
    early = [r for r in want.request_results if r.tokens.size < DECS[r.index]]
    assert early and all(r.tokens[-1] == eos for r in early)
    hw = _tight_hw(cfg, HardwareProfile) if continuous else None
    got = {1: serve_dataset(cfg, tp, [Request(p, d) for p, d in zip(prompts, DECS)],
                            Plan(**KW, decode_chunk=1), 4, scheduler=scheduler, eos_id=eos,
                            hw=hw, device="cpu"),
           8: _serve(Server(cfg, tp, Plan(**KW, decode_chunk=8), serve=ServeConfig(
               scheduler=scheduler, decode_len=4, eos_id=eos, hw=hw), device="cpu"),
               [Request(p, d) for p, d in zip(prompts, DECS)])}
    for rep in got.values():
        assert [r.index for r in rep.request_results] == [r.index for r in
                                                           want.request_results]
        for a, b in zip(want.request_results, rep.request_results):
            assert np.array_equal(a.tokens, b.tokens), (a.index, a.tokens, b.tokens)
            assert a.decode_steps == b.decode_steps
        assert rep.decode_slot_steps == want.decode_slot_steps
        assert rep.wasted_slot_steps == want.wasted_slot_steps
        assert rep.admission_deferrals == want.admission_deferrals
        assert rep.admission_deferrals > 0 if continuous else rep.admission_deferrals == 0


def test_open_loop_arrivals_match_jax_server(smoke):
    """Continuous admission of requests stamped with ``--arrival-trace``
    offsets: per-request tokens equal the JAX server's (admission reads a
    wall clock, so only the tokens are compared), and every request is
    admitted at or after its arrival."""
    jcfg, cfg, jp, tp, prompts, _ = smoke("olmoe-1b-7b")
    times = jarrivals.trace([0.0, 0.0, 0.05, 0.1, 0.3, 0.31])
    reqs = {}
    for side, Req in (("jax", JRequest), ("port", Request)):
        reqs[side] = [Req(p, d) for p, d in zip(prompts, DECS)]
        for r, t in zip(reqs[side], times):
            r.arrival_s = float(t)
    want = _serve(JServer(jcfg, jp, JPlan(**KW), serve=JServeConfig(
        scheduler="continuous", decode_len=4)), reqs["jax"])
    server = Server(cfg, tp, Plan(**KW), serve=ServeConfig(scheduler="continuous",
                                                           decode_len=4), device="cpu")
    handles = [server.submit(r) for r in reqs["port"]]
    got = server.run()
    by_index = {r.index: r.tokens for r in got.request_results}
    for a in want.request_results:
        assert np.array_equal(a.tokens, by_index[a.index]), a.index
    for h in handles:
        assert h.admit_s >= h.arrival_s and h.first_token_s >= h.admit_s


def _reference_requests(flags, vocab):
    """``src/repro/launch/serve.py``'s construction (its lines building the
    requests), from the reference's own modules."""
    a = launch.parse_args(flags)
    spec = JDatasetSpec("serve", a.requests, a.prompt_len, a.decode_len)
    times = None
    if a.arrival_trace:
        times = jarrivals.trace([float(x) for x in a.arrival_trace.split(",")])
    elif a.arrival_rate is not None:
        times = jarrivals.poisson(a.requests, a.arrival_rate, seed=a.seed)
    sp = jsampling.SamplingParams(temperature=a.temperature, top_k=a.top_k, seed=a.seed)
    return jsynthetic_requests(spec, vocab, prompt_lens=a.prompt_lens,
                               decode_lens=a.decode_lens, arrivals=times,
                               sampling=sp if not sp.is_greedy else None)


@pytest.mark.parametrize("flags", [
    ["--requests", "5", "--prompt-len", "17", "--decode-len", "6"],
    ["--requests", "9", "--prompt-len", "40", "--prompt-lens", "5,11,3",
     "--decode-lens", "4,9", "--arrival-rate", "12.5", "--temperature", "0.7",
     "--top-k", "5", "--seed", "3"],
    ["--requests", "4", "--arrival-trace", "0,0.5,1.2,1.2", "--arrival-rate", "3"],
], ids=["prompt-len", "mixed", "trace"])
def test_launcher_requests_equal_the_reference_launchers(flags):
    cfg = get_config("olmoe-1b-7b", smoke=True)
    got = launch.build_requests(launch.parse_args(flags), cfg)
    want = _reference_requests(flags, cfg.vocab_size)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g.prompt, w.prompt) and g.prompt.dtype == w.prompt.dtype
        assert g.decode_len == w.decode_len and g.arrival_s == w.arrival_s
        if w.sampling is None:
            assert g.sampling is None
        else:
            assert (g.sampling.temperature, g.sampling.top_k, g.sampling.seed) == (
                w.sampling.temperature, w.sampling.top_k, w.sampling.seed)


@pytest.mark.parametrize("B,V,temperature,k,seed", [
    (1, 7, 1.0, 3, 0), (4, 50, 0.8, 5, 3), (8, 257, 1.3, 50, 11), (16, 1000, 0.5, 1, 7),
])
def test_sampling_helpers_match_jax(B, V, temperature, k, seed):
    """``temperature_sample`` and ``top_k_sample`` under the port's threefry
    key give the JAX functions' tokens for the same seed; ties in the top-k
    (repeated logits) break to the lower index, as ``jax.lax.top_k``;
    temperature 1e-4 and k = 1 give the greedy tokens
    (``tests/test_serving.py::test_sampling_strategies``)."""
    logits = np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * 3
    logits[:, V // 2:V // 2 + 2] = logits[:, :1]           # ties with column 0
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jkey, key = jax.random.PRNGKey(seed), prng.key_from_seed(seed)
    assert np.array_equal(np.asarray(jkey, np.uint32), key)
    want = np.asarray(jsampling.temperature_sample(jkey, jl, temperature))
    assert np.array_equal(sampling.temperature_sample(key, tl, temperature).numpy(), want)
    want = np.asarray(jsampling.top_k_sample(jkey, jl, k, temperature))
    assert np.array_equal(sampling.top_k_sample(key, tl, k, temperature).numpy(), want)
    greedy = logits.argmax(-1)
    assert np.array_equal(sampling.temperature_sample(key, tl, 1e-4).numpy(), greedy)
    assert np.array_equal(sampling.temperature_sample(key, tl, 0.0).numpy(), greedy)
    assert np.array_equal(sampling.top_k_sample(key, tl, 1).numpy(), greedy)


@pytest.mark.parametrize("cf", [64.0, 0.5], ids=["no-drops", "drops"])
def test_capacity_oracle_matches_jax(cf):
    """``moe_apply_capacity_local`` within 1e-5 of the reference's y and aux
    loss, with room for every copy (then equal to the exact dense combine)
    and with a capacity factor that drops copies."""
    jcfg = replace(jget("olmoe-1b-7b", smoke=True), dtype="float32", capacity_factor=cf)
    cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype="float32",
                  capacity_factor=cf)
    key = jax.random.PRNGKey(2)
    jp = jmoe.init_moe_params(jcfg, key)
    x = np.array(jax.random.normal(key, (2, 16, cfg.d_model)) * 0.3, np.float32)
    jy, jaux = jmoe.moe_apply_capacity_local(jcfg, jp, jnp.asarray(x))
    p = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    y, aux = moe.moe_apply_capacity_local(cfg, p, torch.from_numpy(x))
    assert y.shape == (2, 16, cfg.d_model) and y.dtype == torch.float32
    assert float((y - torch.from_numpy(np.array(jy))).abs().max()) < 1e-5
    assert abs(float(aux) - float(jaux)) < 1e-5
    exact, _ = moe.moe_apply_local(cfg, p, torch.from_numpy(x))
    gap = float((y - exact).abs().max())
    assert gap < 1e-5 if cf > 1 else gap > 1e-3


def test_report_means_and_dtoh():
    """``mean_ttft_s``, ``mean_tpot_s`` and ``kv_dtoh_gb`` are the means and
    bytes they are defined from, and equal the reference report's."""
    rng = np.random.default_rng(0)
    rows = [dict(index=i, tokens=np.zeros(3, np.int32), latency_s=1.0, decode_steps=2,
                 ttft_s=float(a), tpot_s=float(b))
            for i, (a, b) in enumerate(rng.uniform(0.001, 2.0, (5, 2)))]
    rep = ServeReport(request_results=[RequestResult(**r) for r in rows],
                      kv_dtoh_bytes=123_456_789)
    jrep = JServeReport(request_results=[JRequestResult(**r) for r in rows],
                        kv_dtoh_bytes=123_456_789)
    assert rep.mean_ttft_s == pytest.approx(np.mean([r["ttft_s"] for r in rows]), rel=1e-12)
    assert rep.mean_tpot_s == pytest.approx(np.mean([r["tpot_s"] for r in rows]), rel=1e-12)
    assert rep.kv_dtoh_gb == 0.123456789
    assert (rep.mean_ttft_s, rep.mean_tpot_s, rep.kv_dtoh_gb) == (
        jrep.mean_ttft_s, jrep.mean_tpot_s, jrep.kv_dtoh_gb)
    empty = ServeReport()
    assert (empty.mean_ttft_s, empty.mean_tpot_s, empty.kv_dtoh_gb) == (0.0, 0.0, 0.0)


def test_launcher_serves_open_loop_traffic_on_the_cpu():
    """The launcher with every traffic flag: continuous, ragged decode
    lengths, EOS, Poisson arrivals and top-k sampling, on the smoke config;
    it prints the reference's report lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--smoke", "--device", "cpu", "--scheduler", "continuous",
                     "--requests", "6", "--batch", "4", "--prompt-lens", "5,9",
                     "--decode-lens", "2,5,9", "--eos-id", "3", "--arrival-rate", "50",
                     "--temperature", "0.7", "--top-k", "5", "--omega", "0"])
    text = out.getvalue()
    assert "[continuous] served 6 requests" in text
    assert "mean request latency" in text and "mean queue wait" in text
    assert "TTFT p50/p95" in text and "TPOT p50/p95" in text
    assert text.count(", mean ") >= 2 and "per-expert routed copies" in text
