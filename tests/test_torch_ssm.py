"""The port's SSM (Mamba2/SSD) path against the JAX package on the CPU.

The same seeded numpy inputs go through the JAX functions and their port:
K5's plain version against the reference scan and the Pallas kernel in
interpret mode, ``ssm_forward`` and ``ssm_decode`` on the mamba2 smoke
config in f32, and the port's own prefill-then-decode contract."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# PyTorch's CPU exp can be less accurate on its first multithreaded call in
# a process (7e-5 relative, seen on torch 2.13's CPU build); warm it once
torch.exp(torch.linspace(-10.0, 0.0, 1 << 20))

TOL = {"float32": 2e-5, "bfloat16": 0.05}   # tests/test_kernels.py's TOL
STATE_TOL = {"float32": 1e-2, "bfloat16": 0.5}
F32 = 1e-5                                  # f32 module outputs: sum order only


def _scan_inputs(Bt, S, nh, hp, ns, seed=0):
    """tests/test_kernels.py's SSD inputs, from numpy: x, B, C at scale 0.5,
    dt = softplus(normal), A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, nh, hp)).astype(np.float32) * 0.5
    B = rng.standard_normal((Bt, S, ns)).astype(np.float32) * 0.5
    C = rng.standard_normal((Bt, S, ns)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    return x, B, C, dt, A


def _both(arrays, dtype):
    """The same values as JAX and torch arrays: x, B and C rounded to
    ``dtype`` (round to nearest even on both sides), dt and A f32."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    j = [jnp.asarray(a).astype(jd) for a in arrays[:3]] + [jnp.asarray(a) for a in arrays[3:]]
    t = [torch.from_numpy(a).to(td) for a in arrays[:3]] + [torch.from_numpy(a)
                                                         for a in arrays[3:]]
    return j, t


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,nh,hp,ns,chunk", [(256, 4, 32, 16, 64), (128, 8, 16, 32, 32)])
@pytest.mark.parametrize("oracle", ["reference_scan", "pallas_interpret"])
def test_ssd_scan_ref_matches_jax(oracle, S, nh, hp, ns, chunk, dtype):
    """K5's plain version against ``repro.models.ssm.ssd_scan`` and the
    Pallas kernel in interpret mode, at tests/test_kernels.py's shapes and
    bounds (y within 4 x TOL, the state within 1e-2 in f32, 0.5 in bf16)."""
    (xj, Bj, Cj, dtj, Aj), (xt, Bt_, Ct, dtt, At) = _both(_scan_inputs(2, S, nh, hp, ns), dtype)
    if oracle == "reference_scan":
        yj, hj = jssm.ssd_scan(xj, Bj, Cj, dtj, Aj, chunk)
    else:
        yj, hj = jops.ssd_scan(xj, Bj, Cj, dtj, Aj, chunk, interpret=True)
    yt, ht = ref.ssd_scan_ref(xt, Bt_, Ct, dtt, At, chunk)
    assert yt.dtype == xt.dtype and ht.dtype == torch.float32
    assert np.abs(_np(yt.float()) - _np(yj)).max() < 4 * TOL[dtype]
    assert np.abs(ht.numpy() - _np(hj)).max() < STATE_TOL[dtype]


@pytest.mark.parametrize("case", ["lengths", "ragged_tail"])
def test_ssd_scan_ref_padding_matches_jax(case):
    """``lengths`` not multiples of the chunk (one of them 1): valid rows and
    the state equal the JAX scan's on the same inputs with dt zeroed past
    each length, and every row past a length is zero.  S not a multiple of
    the chunk: the JAX scan on the input right-padded to the multiple."""
    chunk, S = 32, 100 if case == "ragged_tail" else 128
    x, B, C, dt, A = _scan_inputs(4, S, 4, 32, 16, seed=1)
    lengths = np.array([128, 45, 1, 97]) if case == "lengths" else None
    if case == "lengths":
        live = np.arange(S)[None, :] < lengths[:, None]
        dtz = dt * live[..., None]
        yj, hj = jssm.ssd_scan(*map(jnp.asarray, (x, B, C, dtz, A)), chunk)
    else:
        pad = -S % chunk
        padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                  for a in (x, B, C, dt)]
        yj, hj = jssm.ssd_scan(*map(jnp.asarray, padded + [A]), chunk)
        yj = yj[:, :S]
    lens = None if lengths is None else torch.from_numpy(lengths)
    yt, ht = ref.ssd_scan_ref(*map(torch.from_numpy, (x, B, C, dt, A)), chunk,
                              lengths=lens)
    assert yt.shape == x.shape
    for b, n in enumerate(lengths if lengths is not None else [S] * 4):
        assert np.abs(yt.numpy()[b, :n] - _np(yj)[b, :n]).max() < 4 * TOL["float32"]
        assert torch.count_nonzero(yt[b, n:]) == 0
    assert np.abs(ht.numpy() - _np(hj)).max() < 4 * TOL["float32"]


def _ssm_setup(seed=0):
    jcfg = replace(jget("mamba2-370m", smoke=True), dtype="float32")
    cfg = replace(get_config("mamba2-370m", smoke=True), dtype="float32")
    jp = jssm.init_ssm_params(jcfg, jax.random.PRNGKey(seed))
    tp = {k: to_tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def test_ssm_forward_with_lengths_matches_jax():
    """Outputs on valid rows, the state ``h`` and the conv tail, on a ragged
    batch with a row shorter than W - 1 (its tail is zero padded)."""
    jcfg, cfg, jp, tp = _ssm_setup()
    x = np.random.default_rng(2).standard_normal((4, 64, cfg.d_model)).astype(np.float32)
    lengths = np.array([64, 45, 2, 33])
    yj, sj = jssm.ssm_forward(jcfg, jp, jnp.asarray(x), lengths=jnp.asarray(lengths))
    yt, st = ssm.ssm_forward(cfg, tp, torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):
        assert np.abs(yt.numpy()[b, :n] - _np(yj)[b, :n]).max() < F32
    assert np.abs(st["h"].numpy() - _np(sj["h"])).max() < F32
    assert np.abs(st["conv"].numpy() - _np(sj["conv"])).max() < F32
    assert np.count_nonzero(st["conv"].numpy()[2, 0]) == 0    # row of length 2


def test_ssm_decode_matches_jax():
    jcfg, cfg, jp, tp = _ssm_setup()
    rng = np.random.default_rng(3)
    B = 3
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    st0 = jssm.init_ssm_state(jcfg, B)
    h = rng.standard_normal(st0["h"].shape).astype(np.float32)
    conv = rng.standard_normal(st0["conv"].shape).astype(np.float32)
    yj, sj = jssm.ssm_decode(jcfg, jp, jnp.asarray(x),
                             {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    state = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(conv.copy())}
    ptrs = (state["h"].data_ptr(), state["conv"].data_ptr())
    yt, st = ssm.ssm_decode(cfg, tp, torch.from_numpy(x), state)
    assert np.abs(yt.numpy() - _np(yj)).max() < F32
    assert np.abs(st["h"].numpy() - _np(sj["h"])).max() < F32
    assert np.abs(st["conv"].numpy() - _np(sj["conv"])).max() < F32
    assert (st["h"].data_ptr(), st["conv"].data_ptr()) == ptrs    # in place


@pytest.mark.parametrize("P", [0, 5, 40])
def test_prefill_then_decode_equals_full_forward(P):
    """The port's own contract (tests/test_ssm.py:52): prefill the first P
    tokens, then decode the rest one by one; every output and the final
    state equal the full forward's.  P = 0 decodes from the zero state."""
    _, cfg, _, tp = _ssm_setup()
    B, S = 2, 48
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32) * 0.1)
    y_full, st_full = ssm.ssm_forward(cfg, tp, x)
    if P:
        y_pre, st = ssm.ssm_forward(cfg, tp, x[:, :P])
        outs = [y_pre]
    else:
        st = ssm.init_ssm_state(cfg, B, device="cpu")
        outs = []
    for t in range(P, S):
        y, st = ssm.ssm_decode(cfg, tp, x[:, t:t + 1], st)
        outs.append(y)
    y_step = torch.cat(outs, dim=1)
    assert float((y_step - y_full).abs().max()) < 1e-4
    assert float((st["h"] - st_full["h"]).abs().max()) < 1e-4
    assert float((st["conv"] - st_full["conv"]).abs().max()) < F32


def test_init_ssm_state_defaults_to_cuda_and_never_falls_back():
    cfg = get_config("mamba2-370m", smoke=True)
    st = ssm.init_ssm_state(cfg, 2, device="cpu")
    assert st["h"].shape == (2, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim)
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init_ssm_state(cfg, 2)
