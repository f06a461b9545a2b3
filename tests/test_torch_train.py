"""Training in the port against the JAX package on the CPU, in f32: the loss
and every gradient, one AdamW step, the differentiable attention and SSM
math, remat, checkpoints, the training launcher, and the guard that keeps
the kernels (which have no backward) out of autograd."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.train.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as jadamw_update  # noqa: E402
from repro_torch.bridge import from_numpy_params, unstack_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.datasets import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.train.optimizer import adamw_init, adamw_update, tree_leaves  # noqa: E402
from repro_torch.train.train_loop import make_train_step, train_loop  # noqa: E402

LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _setup(arch, dtype="float32"):
    jcfg = replace(jget(arch, smoke=True), dtype=dtype)
    cfg = replace(get_config(arch, smoke=True), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _named(tree, prefix=""):
    """(path, leaf) of the port's tree: dicts by key, the layer list by index."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _grads(cfg, tp, toks, labels, **kw):
    named = _named(tp)
    for _, t in named:
        t.requires_grad_(True)
    total, (nll, aux) = M.loss_fn(cfg, tp, torch.from_numpy(toks).long(),
                                  torch.from_numpy(labels).long(), **kw)
    grads = torch.autograd.grad(total, [t for _, t in named], allow_unused=True)
    return total.detach(), {n: (torch.zeros_like(t) if g is None else g)
                            for (n, t), g in zip(named, grads)}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (remat on, the default) and the gradient of every leaf
    against ``jax.value_and_grad`` of the reference's: attention, MoE
    (router, dense combine, aux loss) and the SSM scan."""
    jcfg, cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    (jl, (jn, ja)), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(toks), jnp.asarray(labels), remat=False),
        has_aux=True)(jp)
    total, grads = _grads(cfg, tp, toks, labels)
    assert abs(float(total) - float(jl)) / abs(float(jl)) < LOSS_REL
    jg = jax.tree.map(np.asarray, jg)
    jg = {**{k: v for k, v in jg.items() if k != "layers"},
          "layers": unstack_layers(cfg, jg["layers"])}
    for name, g in grads.items():
        want = _at(jg, name)
        peak = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) / peak < GRAD_REL, name


def test_remat_policies_give_the_same_loss_and_grads():
    """Remat off, ``"full"`` and ``"dots"`` compute the same loss and
    gradients (recomputation repeats the same arithmetic)."""
    _, cfg, _, tp = _setup("olmoe-1b-7b")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    l0, g0 = _grads(cfg, tp, toks, labels, remat=False)
    for policy in ("full", "dots"):
        l1, g1 = _grads(cfg, tp, toks, labels, remat=True, remat_policy=policy)
        torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
        for name in g0:
            torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="remat_policy"):
        M.loss_fn(cfg, tp, torch.from_numpy(toks).long(), torch.from_numpy(labels).long(),
                  remat_policy="everything")


def test_chunked_loss_matches_full_logits():
    """tests/test_train.py's check, mirrored: the chunked vocabulary loss
    against ``softmax_cross_entropy`` of ``forward``'s full logits."""
    _, cfg, _, tp = _setup("internlm2-1.8b")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    labels = torch.roll(toks, -1, 1)
    chunked, (nll, aux) = M.loss_fn(cfg, tp, toks, labels, remat=False, aux_weight=0.0,
                                    vocab_chunk=8)
    logits, _, _ = M.forward(cfg, tp, toks)
    full = softmax_cross_entropy(logits, labels)
    assert abs(float(chunked) - float(full)) < 1e-5
    one, _ = M.loss_fn(cfg, tp, toks, labels, remat=False, aux_weight=0.0, vocab_chunk=32)
    torch.testing.assert_close(one, chunked, rtol=1e-6, atol=0)


def test_adamw_matches_reference():
    """Three AdamW steps on the same numpy gradients (the second one
    clipped) give the JAX optimizer's parameters and moments."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 8), "b": [(16,), (3, 5)]}
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": [torch.from_numpy(p.copy()) for p in params["b"]]}
    jp = jax.tree.map(jnp.asarray, params)
    tstate, jstate = adamw_init(tp), jadamw_init(jp)
    for step, mag in enumerate((0.1, 50.0, 0.3)):
        g = {"a": (mag * rng.standard_normal((4, 8))).astype(np.float32),
             "b": [(mag * rng.standard_normal(s)).astype(np.float32) for s in shapes["b"]]}
        jp, jstate, jn = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jstate, lr=1e-2)
        tp, tstate, tn = adamw_update(tp, {"a": torch.from_numpy(g["a"]),
                                           "b": [torch.from_numpy(x) for x in g["b"]]},
                                      tstate, lr=1e-2)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert abs(float(tn) - float(jn)) / float(jn) < 1e-6
        for got, want in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_grad_clip_bounds_update():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 1e6)}
    new_params, state, gnorm = adamw_update(params, grads, adamw_init(params), lr=1e-2,
                                            weight_decay=0.0)
    assert float(gnorm) > 1e5
    assert float((new_params["w"] - 1.0).abs().max()) < 0.05      # clipped: ~lr
    assert new_params["w"] is params["w"] and state.mu["w"].abs().max() > 0


def test_loss_decreases():
    """tests/test_train.py's bar: 12 steps on one fixed batch lower the loss
    by more than 0.2; every metric stays a tensor until read."""
    _, cfg, _, tp = _setup("qwen2-1.5b", dtype="bfloat16")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    step = make_train_step(cfg, lr=3e-3, remat=False)
    opt = adamw_init(tp)
    tokens, labels = (torch.from_numpy(a).long() for a in
                      next(synthetic_batches(cfg.vocab_size, 4, 32)))
    losses = []
    for _ in range(12):
        tp, opt, m = step(tp, opt, tokens, labels)
        assert all(torch.is_tensor(v) for v in m.values())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp) if t.dim() > 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoint_round_trip(tmp_path, dtype):
    """Bit-exact through the npz (bf16 leaves stored as f32 under
    ``::bf16``), with the step; a template of another shape or dtype is
    refused."""
    cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype=dtype)
    params = M.init_params(cfg, seed=3, device="cpu")
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, params, step=17)
    keys = set(np.load(path).files)
    assert "layers/1/moe/experts_w_gate" + ("::bf16" if dtype == "bfloat16" else "") in keys
    restored, step = load_checkpoint(path[:-4], M.init_params(cfg, seed=4, device="cpu"))
    assert step == 17
    for (na, a), (nb, b) in zip(_named(params), _named(restored)):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b)
    bad = M.init_params(replace(cfg, d_model=cfg.d_model * 2), seed=0, device="cpu")
    with pytest.raises(AssertionError):
        load_checkpoint(path, bad)
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    with pytest.raises((AssertionError, KeyError)):
        load_checkpoint(path, M.init_params(replace(cfg, dtype=other), seed=0, device="cpu"))


def test_train_launcher_runs_smoke_steps_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` in process: 3
    smoke steps, the reference's log line, and a checkpoint written by
    ``train_loop``."""
    train_launcher.main(["--device", "cpu", "--steps", "3", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "3 steps of 2x16 on cpu" in out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("step")] == \
        ["1", "2", "3"]
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = M.init_params(cfg, seed=0, device="cpu")
    batches = ((torch.from_numpy(t).long(), torch.from_numpy(lab).long())
               for t, lab in synthetic_batches(cfg.vocab_size, 2, 16))
    path = os.path.join(tmp_path, "run.npz")
    _, opt, history = train_loop(cfg, params, batches, steps=2, log_every=2,
                                 checkpoint_path=path, checkpoint_every=2)
    assert [h["step"] for h in history] == [1, 2] and int(opt.step) == 2
    restored, step = load_checkpoint(path, params)
    assert step == 2 and all(torch.equal(a, b) for a, b in
                             zip(tree_leaves(params), tree_leaves(restored)))


def test_train_launcher_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# The differentiable math, piece by piece, values and gradients
# ---------------------------------------------------------------------------
def _qkv(rng, B, S, H, K, D):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


@pytest.mark.parametrize("kind", ["naive", "blocked", "swa", "blocked-masked"])
def test_attention_math_matches_reference(kind):
    """naive / blocked / sliding-window attention at small blocks: outputs
    and the gradients of q, k and v against the reference's."""
    rng = np.random.default_rng(4)
    B, S, H, K, D = 2, 32, 4, 2, 8
    q, k, v = _qkv(rng, B, S, H, K, D)
    lens = np.array([32, 19])
    mask = np.arange(S)[None, :] < lens[:, None]
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def pick(mod, masked):
        kv = {"kv_mask": (jnp.asarray(mask) if mod is jattn else torch.from_numpy(mask))
              } if masked else {}
        return {"naive": lambda *a: mod.naive_attention(*a, window=5, **kv),
                "blocked": lambda *a: mod.blocked_attention(*a, q_block=8, kv_block=8),
                "blocked-masked": lambda *a: mod.blocked_attention(*a, q_block=8, kv_block=8,
                                                                   window=12, **kv),
                "swa": lambda *a: mod.swa_attention(*a, window=8, q_block=8)}[kind]

    masked = kind in ("naive", "blocked-masked")
    jf = pick(jattn, masked)
    jo, jvjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = jvjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = pick(attn, masked)(tq, tk, tv)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(w))
    rows = mask[:, :, None, None] if masked else np.ones((B, S, 1, 1), bool)
    np.testing.assert_allclose(to.detach().numpy() * rows, np.asarray(jo) * rows,
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_full_attention_dispatch_matches_reference():
    """The differentiable ``full_attention`` picks the reference's branch:
    past the window the sliding-window one (whose blocks need S > window +
    512), within 1024 positions the naive one."""
    rng = np.random.default_rng(5)
    for S, window in ((40, 8), (1040, 16)):
        q, k, v = _qkv(rng, 1, S, 2, 1, 8)
        want = np.asarray(jattn.full_attention(*map(jnp.asarray, (q, k, v)), window=window))
        got = attn.full_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                                  differentiable=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ssd_scan_matches_reference():
    """The reference's chunked scan in the port (several chunks, an initial
    state): y, the final state and the gradients of every input."""
    rng = np.random.default_rng(6)
    Bt, S, nh, hp, ns, Q = 2, 24, 3, 4, 5, 8
    x = rng.standard_normal((Bt, S, nh, hp)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bt, S, ns)).astype(np.float32) for _ in range(2))
    dt = (0.1 + 0.5 * rng.random((Bt, S, nh))).astype(np.float32)
    A = -(1.0 + rng.random(nh)).astype(np.float32)
    h0 = rng.standard_normal((Bt, nh, ns, hp)).astype(np.float32)
    ins = (x, Bm, Cm, dt, A)
    (jy, jh), jvjp = jax.vjp(lambda *a: jssm.ssd_scan(*a, Q, h0=jnp.asarray(h0)),
                             *map(jnp.asarray, ins))
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal(h0.shape).astype(np.float32)
    jgrads = jvjp((jnp.asarray(wy), jnp.asarray(wh)))
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    ty, th = ssm.ssd_scan(*tins, Q, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    tgrads = torch.autograd.grad((ty, th), tins, (torch.from_numpy(wy), torch.from_numpy(wh)))
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The kernels stay out of autograd
# ---------------------------------------------------------------------------
def _kernel_calls(rg):
    """Every public kernel op on small CPU inputs; ``rg`` marks inputs that
    require grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(s, generator=g, dtype=dt).requires_grad_(rg)  # noqa: E731
    x, wg, wu, wd = r(2, 4, 8), r(2, 8, 16), r(2, 8, 16), r(2, 16, 8)
    q3, k, v = r(2, 4, 8), r(2, 6, 2, 8), r(2, 6, 2, 8)
    q4 = r(2, 6, 4, 8)
    xs, bs, cs = r(1, 8, 2, 4), r(1, 8, 3), r(1, 8, 3)
    dt, A = r(1, 8, 2).abs(), -r(2).abs()
    frames = torch.tensor([[0, 1]], dtype=torch.int32)
    pk, pv = r(3, 4, 2, 8), r(3, 4, 2, 8)
    return {
        "expert_gate_up": lambda: ops.expert_gate_up(x, wg, wu),
        "grouped_matmul": lambda: ops.grouped_matmul(x, wg),
        "grouped_expert_ffn": lambda: ops.grouped_expert_ffn(x, wg, wu, wd),
        "decode_attention": lambda: ops.decode_attention(q3, k, v, 3),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q3[:1], pk, pv, None, None, frames, 5, 8),
        "flash_attention": lambda: ops.flash_attention(q4, k, v),
        "ssd_scan": lambda: ops.ssd_scan(xs, bs, cs, dt, A, 4),
    }


def test_kernel_ops_refuse_autograd():
    """Each kernel op raises naming itself when grad mode is on and an input
    requires grad -- on CPU tensors too, where its plain version would
    differentiate and hide that the card's output has no ``grad_fn``; under
    ``no_grad`` or without such an input it runs."""
    for name, call in _kernel_calls(True).items():
        with pytest.raises(RuntimeError, match=name):
            call()
        with torch.no_grad():
            call()
    for call in _kernel_calls(False).values():
        call()
    # the serving forward reaches K4 on grad-requiring weights: refused
    _, cfg, _, tp = _setup("qwen2-1.5b")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="flash_attention"):
        M.forward(cfg, tp, toks, differentiable=False)
    M.forward(cfg, tp, toks)                            # the differentiable default


def test_router_logits_differentiable_form_is_bit_identical():
    """``router_logits`` under autograd (``torch.cat`` of the block
    products) equals the served form (``mm`` into a preallocated buffer) bit
    for bit, over one and several ``ROUTER_ROWS`` blocks, and has a
    ``grad_fn``."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    for n in (5, moe.ROUTER_ROWS, 2 * moe.ROUTER_ROWS + 37):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32)).to(dt)
            served = moe.router_logits(w, x)
            assert served.grad_fn is None
            xg = x.clone().requires_grad_(True)
            diff = moe.router_logits(w, xg)
            assert diff.grad_fn is not None
            assert torch.equal(diff.detach(), served)
            wg = w.clone().requires_grad_(True)
            assert torch.equal(moe.router_logits(wg, x).detach(), served)
