"""Port model math vs the JAX reference on the CPU, in f32.

The same seeded numpy inputs and the JAX init's weights (carried over by
``repro_torch.bridge``) go through both sides."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.kvcache import cache_from_prefill as jcache  # noqa: E402
from repro_torch.bridge import from_numpy_params, to_tensor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving.kvcache import cache_from_prefill  # noqa: E402

RNG = np.random.default_rng(0)
TOL = 1e-5          # f32 elementwise/short reductions: summation order only
REL = 1e-4          # logits bound of tests/test_engine.py:47-54


def _cfgs(arch):
    return (replace(jget(arch, smoke=True), dtype="float32"),
            replace(get_config(arch, smoke=True), dtype="float32"))


def _params(arch):
    jcfg, cfg = _cfgs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return np.asarray(x, dtype=np.float32)


def test_rms_norm_and_rope_match():
    x = RNG.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = RNG.standard_normal(32).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    assert np.abs(got.numpy() - _np(want)).max() < TOL
    pos = np.array([[0, 3, 7, 100, 511]])
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4     # f32 sin/cos at 511


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_attn_forward_and_decode_match(arch):
    jcfg, cfg, jp, tp = _params(arch)
    pj, pt = jp["layers"][0]["attn"], tp["layers"][0]["attn"]
    pj = jax.tree.map(lambda a: a[0], pj)
    B, S = 3, 12
    x = RNG.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lengths = np.array([12, 7, 3])
    yj, cj = jattn.attn_forward(jcfg, pj, jnp.asarray(x),
                                lengths=jnp.asarray(lengths))
    yt, ct = attn.attn_forward(cfg, pt, torch.from_numpy(x),
                               lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):          # pad-position outputs are never read
        assert np.abs(yt.numpy()[b, :n] - _np(yj)[b, :n]).max() < TOL
    assert np.abs(ct["k"].numpy() - _np(cj["k"])).max() < TOL
    # decode with per-row positions against a span-16 cache
    span = 16
    ck = RNG.standard_normal((B, span, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    cv = RNG.standard_normal(ck.shape).astype(np.float32)
    xd = RNG.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([12, 7, 3], np.int32)
    yj, cj = jattn.attn_decode(jcfg, pj, jnp.asarray(xd),
                               {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                               jnp.asarray(pos))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    ptr = cache["k"].data_ptr()
    yt, ct = attn.attn_decode(cfg, pt, torch.from_numpy(xd), cache,
                              torch.from_numpy(pos))
    assert np.abs(yt.numpy() - _np(yj)).max() < TOL
    assert np.abs(ct["k"].numpy() - _np(cj["k"])).max() < TOL
    assert np.abs(ct["v"].numpy() - _np(cj["v"])).max() < TOL
    assert ct["k"].data_ptr() == ptr          # written in place


def test_full_attention_past_1024_tokens_goes_through():
    """Prefill attention takes any length (K4's slice): 1025 tokens, which
    the first slice refused, give finite outputs of the input's shape."""
    q = torch.from_numpy(RNG.standard_normal((1, 1025, 2, 32)).astype(np.float32))
    out = attn.full_attention(q, q, q)
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_full_attention_beyond_its_slice_raises():
    """What stays beyond the slice is the engine's prompt beyond a sliding
    window, which the reference engine refuses too."""
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine

    cfg = replace(get_config("h2o-danube-1.8b", smoke=True), dtype="float32")
    eng = ModuleBatchingEngine(cfg, M.init_params(cfg, seed=0, device="cpu"),
                               Plan(B=1, b_a=1, b_e=1), max_seq=80, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        eng.prefill(np.zeros((1, cfg.sliding_window + 1), np.int64))


def test_init_cache_defaults_to_cuda_and_never_falls_back():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    assert len(cache) == cfg.num_layers
    assert cache[0]["k"].shape == (2, 16, cfg.num_kv_heads, cfg.head_dim)
    assert cache[0]["k"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for make in (lambda: M.init_cache(cfg, 2, 16),
                 lambda: attn.init_kv_cache(cfg, 2, 16)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def _prefill_and_decode_match(arch, B, S, DEC, lengths=None):
    """Reference ``M.prefill`` + ``decode_step`` against the port's, f32:
    logits within REL of their scale, identical greedy tokens."""
    jcfg, cfg, jp, tp = _params(arch)
    toks = RNG.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lg_j, caches = JM.prefill(jcfg, jp, jnp.asarray(toks))
    lg_t, tcaches = M.prefill(cfg, tp, torch.from_numpy(toks).long())
    scale = float(np.abs(_np(lg_j)).max())
    assert np.abs(lg_t.numpy() - _np(lg_j)).max() / scale < REL
    nxt = np.array(jnp.argmax(lg_j[:, 0], -1))
    assert np.array_equal(lg_t[:, 0].argmax(-1).numpy(), nxt)
    cj = jcache(jcfg, caches, S, max_seq=S + DEC)
    ct = cache_from_prefill(cfg, tcaches, S + DEC)
    for t in range(DEC):
        lj, cj = JM.decode_step(jcfg, jp, cj, jnp.asarray(nxt), jnp.int32(S + t))
        lt, ct = M.decode_step(cfg, tp, ct, torch.from_numpy(nxt).long(), S + t)
        assert np.abs(lt.numpy() - _np(lj)).max() / scale < REL
        nxt = np.array(jnp.argmax(lj, -1))
        assert np.array_equal(lt.argmax(-1).numpy(), nxt)


@pytest.mark.parametrize("arch,S", [("olmoe-1b-7b", 1280), ("mixtral-8x7b", 1280),
                                    ("h2o-danube-1.8b", 192)])
def test_model_prefill_long_prompt_matches(arch, S):
    """Prompts past the naive limit of 1024 tokens (olmoe, mixtral: G = 4),
    and past the sliding window (h2o-danube smoke: window 64, G = 4, then
    decode through the ring cache)."""
    _prefill_and_decode_match(arch, B=2, S=S, DEC=2)


def test_route_topk_ties_take_lower_index():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    jcfg = jget("olmoe-1b-7b", smoke=True)
    E = cfg.num_experts
    w = np.zeros((8, E), np.float32)          # all-equal logits: every tie
    x = RNG.standard_normal((5, 8)).astype(np.float32)
    gj, ij, _ = jmoe.route(jcfg, jnp.asarray(w), jnp.asarray(x))
    gt, it, _ = moe.route(cfg, torch.from_numpy(w), torch.from_numpy(x))
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert np.array_equal(it.numpy()[0], np.arange(cfg.experts_per_token))
    assert np.abs(gt.numpy() - _np(gj)).max() < TOL


@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_grouped_dispatch_matches(capacity):
    jcfg, cfg, jp, tp = _params("olmoe-1b-7b")
    m = jax.tree.map(lambda a: a[0], jp["layers"][0]["moe"])
    mt = tp["layers"][0]["moe"]
    T = 24
    x = RNG.standard_normal((T, cfg.d_model)).astype(np.float32)
    gj, ij, _ = jmoe.route(jcfg, m["router"], jnp.asarray(x))
    gt, it, _ = moe.route(cfg, mt["router"], torch.from_numpy(x))
    assert np.array_equal(it.numpy(), np.asarray(ij))
    yj, kj, dj, lj = jmoe.grouped_dispatch(
        jcfg, jnp.asarray(x), gj, ij, m["experts_w_gate"], m["experts_w_up"],
        m["experts_w_down"], capacity)
    yt, kt, dt, lt = moe.grouped_dispatch(
        cfg, torch.from_numpy(x), gt, it, mt["experts_w_gate"],
        mt["experts_w_up"], mt["experts_w_down"], capacity)
    assert np.abs(yt.numpy() - _np(yj)).max() < TOL
    assert int(kt) == int(kj) and int(dt) == int(dj)
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    # the dense-combine oracle agrees whenever nothing drops
    if int(dj) == 0:
        yl, _ = moe.moe_apply_local(cfg, mt, torch.from_numpy(x)[None])
        assert np.abs(yl[0].numpy() - yt.numpy()).max() < TOL


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_model_prefill_and_decode_match(arch):
    jcfg, cfg, jp, tp = _params(arch)
    B, S, DEC = 4, 12, 4
    toks = RNG.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lg_j, caches = JM.prefill(jcfg, jp, jnp.asarray(toks))
    lg_t, tcaches = M.prefill(cfg, tp, torch.from_numpy(toks).long())
    scale = float(np.abs(_np(lg_j)).max())
    assert np.abs(lg_t.numpy() - _np(lg_j)).max() / scale < REL
    cj = jcache(jcfg, caches, S, max_seq=S + DEC)
    ct = cache_from_prefill(cfg, tcaches, S + DEC)
    nxt = np.array(jnp.argmax(lg_j[:, 0], -1))
    for t in range(2):
        lj, cj = JM.decode_step(jcfg, jp, cj, jnp.asarray(nxt), jnp.int32(S + t))
        lt, ct = M.decode_step(cfg, tp, ct, torch.from_numpy(nxt).long(), S + t)
        assert np.abs(lt.numpy() - _np(lj)).max() / scale < REL
        nxt = np.array(jnp.argmax(lj, -1))
        assert np.array_equal(lt.argmax(-1).numpy(), nxt)


def test_bridge_bf16_round_trip_is_bit_exact():
    import ml_dtypes

    bits = RNG.integers(-2**15, 2**15, 4096, dtype=np.int64).astype(np.int16)
    a = bits.view(ml_dtypes.bfloat16)
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), bits)
    # and through JAX's own bf16 arrays
    j = jnp.asarray(RNG.standard_normal(64), jnp.bfloat16)
    tj = to_tensor(np.asarray(j))
    assert np.array_equal(tj.view(torch.int16).numpy(),
                          np.asarray(j).view(np.int16))


def test_bridge_unstacks_layer_groups():
    from repro.serving.weights import unstack_layers

    cfg = get_config("mixtral-8x7b", smoke=True)      # bf16 weights
    jp = JM.init_params(jget("mixtral-8x7b", smoke=True), jax.random.PRNGKey(1))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    ref_layers = unstack_layers(jget("mixtral-8x7b", smoke=True), jp)
    assert len(tp["layers"]) == len(ref_layers) == cfg.num_layers
    for (_, _, want), got in zip(ref_layers, tp["layers"]):
        for key in ("wq", "wo"):
            a = np.asarray(want["attn"][key]).view(np.int16)
            assert np.array_equal(got["attn"][key].view(torch.int16).numpy(), a)
        a = np.asarray(want["moe"]["experts_w_down"]).view(np.int16)
        assert np.array_equal(
            got["moe"]["experts_w_down"].view(torch.int16).numpy(), a)
    assert tp["embed"].dtype == torch.bfloat16


def test_init_params_shapes_and_default_device():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    p = M.init_params(cfg, seed=3, device="cpu")
    jp = jax.eval_shape(lambda: JM.init_params(jget("olmoe-1b-7b", smoke=True),
                                               jax.random.PRNGKey(0)))
    assert tuple(p["embed"].shape) == jp["embed"].shape
    assert tuple(p["layers"][0]["moe"]["experts_w_gate"].shape) == \
        jp["layers"][0]["moe"]["experts_w_gate"].shape[1:]
    assert p["layers"][0]["moe"]["router"].dtype == torch.float32
    assert p["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    q = M.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p["embed"], q["embed"])        # seeded
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(cfg, seed=3)                    # default: cuda, no fallback


@pytest.mark.parametrize("n,E", [(1, 4), (37, 4), (512, 64)])
def test_arrival_slots_match_reference(n, E):
    ids = RNG.integers(0, E, n)
    want = np.asarray(jmoe._arrival_slots(jnp.asarray(ids), E))
    got = moe._arrival_slots(torch.from_numpy(ids), E).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("capacity", [2, 16])
def test_moe_apply_grouped_matches(capacity):
    jcfg, cfg, jp, tp = _params("mixtral-8x7b")
    m = jax.tree.map(lambda a: a[0], jp["layers"][0]["moe"])
    x = RNG.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    yj, aj = jmoe.moe_apply_grouped(jcfg, m, jnp.asarray(x), capacity=capacity)
    yt, at = moe.moe_apply_grouped(cfg, tp["layers"][0]["moe"], torch.from_numpy(x),
                                   capacity=capacity)
    assert np.abs(yt.numpy() - _np(yj)).max() < TOL
    assert abs(float(at) - float(aj)) < TOL
