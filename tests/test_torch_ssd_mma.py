"""The redesigned K5 (the ``mma`` SSD scan), decided and mirrored on the CPU:
which design a CUDA call of each SSM config's shapes takes, and a plain
mirror of the kernel's roundings (``kernels.ref.ssd_scan_mma_ref``: M, the
C H operand H and the state operand w x each as hi + lo bf16 terms, f64
``cum``) against the JAX reference scan, the Pallas kernel in interpret
mode and K5's plain version, at the serve decay range (A = -uniform(1, 16),
chunk 256, |cum| in the thousands).  Bounds: each y row within 0.02 of its
peak, each (row, head) state slice within 1e-4 of its peak.  The kernel
itself is held to the mirror and the plain version in
tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SUPPORTED_CHUNK,
    SUPPORTED_HP,
    SUPPORTED_NS,
    ssd_scan_design,
    ssd_scan_prev,
)

# PyTorch's CPU exp can be less accurate on its first multithreaded call in
# a process (7e-5 relative, seen on torch 2.13's CPU build); warm it once
torch.exp(torch.linspace(-10.0, 0.0, 1 << 20))

Y_REL = 0.02           # chip_smoke.py's REL_BF16, per y row
STATE_REL = 1e-4       # chip_smoke.py's REL_SSD_STATE, per (row, head) slice
Q = 256


def _inputs(Bt, S, nh, hp, ns, seed=0):
    """x, B, C at scale 0.5, dt = softplus(normal), A = -uniform(1, 16)
    (Mamba2's A_log init, chip_smoke.py's serve inputs), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, nh, hp)).astype(np.float32) * 0.5
    B = rng.standard_normal((Bt, S, ns)).astype(np.float32) * 0.5
    C = rng.standard_normal((Bt, S, ns)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, nh)))).astype(np.float32)
    A = -(1.0 + 15.0 * rng.random(nh)).astype(np.float32)
    return x, B, C, dt, A


def _torch(x, B, C, dt, A):
    """x, B and C in bf16 (the served dtype), dt and A in f32."""
    return ([torch.from_numpy(a).bfloat16() for a in (x, B, C)]
            + [torch.from_numpy(dt), torch.from_numpy(A)])


def _jax(x, B, C, dt, A):
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B, C)]
            + [jnp.asarray(dt), jnp.asarray(A)])


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, dtype=np.float32)


def y_rel(got, want):
    """The largest error of a y row (last axis) over that row's peak."""
    d = np.abs(_f32(got) - _f32(want)).max(-1)
    return float((d / np.maximum(np.abs(_f32(want)).max(-1), 1e-30)).max())


def state_rel(got, want):
    """The largest error of a (row, head) state slice over its peak."""
    d = np.abs(_f32(got) - _f32(want)).max((-2, -1))
    return float((d / np.abs(_f32(want)).max((-2, -1))).max())


@pytest.mark.parametrize("Bt,S,nh,hp,ns", [(2, 512, 2, 64, 128),   # Mamba2's widths
                                           (2, 512, 4, 32, 16)])   # the smoke widths
@pytest.mark.parametrize("oracle", ["reference_scan", "pallas_interpret"])
def test_mma_mirror_matches_jax(oracle, Bt, S, nh, hp, ns):
    """Two whole 256-long chunks at the serve decay range: the mirror
    against ``repro.models.ssm.ssd_scan`` and the Pallas kernel (whose f32
    prefix sums are the larger part of the state's difference here)."""
    arrays = _inputs(Bt, S, nh, hp, ns)
    if oracle == "reference_scan":
        yj, hj = jssm.ssd_scan(*_jax(*arrays), Q)
    else:
        yj, hj = jops.ssd_scan(*_jax(*arrays), Q, interpret=True)
    yt, ht = ref.ssd_scan_mma_ref(*_torch(*arrays), Q)
    assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
    assert np.abs(_f32(arrays[3]).cumsum(1)[:, :Q] * arrays[4].min()).max() > 1000
    assert y_rel(yt, yj) < Y_REL
    assert state_rel(ht, hj) < STATE_REL


@pytest.mark.parametrize("lengths", [[600, 1, 256], [437, 512, 255]])
def test_mma_mirror_matches_plain_version(lengths):
    """Against K5's plain version (f64 ``cum`` on both sides, so the
    difference is the mirror's roundings alone) at Mamba2's widths: lengths
    of 1, exactly one chunk, a ragged tail; rows past lengths zero."""
    x, B, C, dt, A = _torch(*_inputs(3, 600, 2, 64, 128, seed=1))
    lens = torch.tensor(lengths)
    ym, hm = ref.ssd_scan_mma_ref(x, B, C, dt, A, Q, lengths=lens)
    yp, hp = ref.ssd_scan_ref(x, B, C, dt, A, Q, lengths=lens)
    for b, n in enumerate(lengths):
        assert y_rel(ym[b, :n], yp[b, :n]) < Y_REL
        assert torch.count_nonzero(ym[b, n:]) == 0
    assert state_rel(hm, hp) < STATE_REL


@pytest.mark.parametrize("case", ["lengths", "ragged_tail"])
def test_mma_mirror_padding_matches_jax(case):
    """``lengths`` of 1, of exactly one chunk and past it: valid rows and
    the state equal the JAX scan's on the same inputs with dt zeroed past
    each length.  S not a multiple of the chunk: the JAX scan on the input
    right-padded to the multiple."""
    S = 300 if case == "ragged_tail" else 512
    x, B, C, dt, A = _inputs(3, S, 2, 32, 16, seed=2)
    lengths = np.array([1, 256, 437]) if case == "lengths" else None
    if case == "lengths":
        dtz = dt * (np.arange(S)[None, :] < lengths[:, None])[..., None]
        yj, hj = jssm.ssd_scan(*_jax(x, B, C, dtz, A), Q)
    else:
        pad = -S % Q
        padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                  for a in (x, B, C, dt)]
        yj, hj = jssm.ssd_scan(*_jax(*padded, A), Q)
        yj = yj[:, :S]
    lens = None if lengths is None else torch.from_numpy(lengths)
    yt, ht = ref.ssd_scan_mma_ref(*_torch(x, B, C, dt, A), Q, lengths=lens)
    assert yt.shape == x.shape
    for b, n in enumerate(lengths if lengths is not None else [S] * 3):
        assert y_rel(yt[b, :n], yj[b, :n]) < Y_REL
        assert torch.count_nonzero(yt[b, n:]) == 0
    assert state_rel(ht, hj) < STATE_REL


def test_single_bf16_rounding_of_the_state_operand_misses_the_bound():
    """Why the state operand enters as hi + lo: one bf16 rounding of the
    f32 product w_j x_j moves the state by far more than 1e-4 of its peak
    at Mamba2's widths; the mirror's hi + lo stays inside it."""
    x, B, C, dt, A = _torch(*_inputs(1, Q, 2, 64, 128, seed=3))
    _, h_plain = ref.ssd_scan_ref(x, B, C, dt, A, Q)
    _, h_mma = ref.ssd_scan_mma_ref(x, B, C, dt, A, Q)
    cum = torch.cumsum((dt * A).double(), dim=1)
    w = torch.exp((cum[:, -1:] - cum).float()) * dt
    wx = (x.float() * w[..., None]).bfloat16().float()
    h_once = torch.einsum("bjs,bjnp->bnsp", B.float(), wx)
    assert state_rel(h_mma, h_plain) < STATE_REL < state_rel(h_once, h_plain)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_k5_design_on_ssm_configs(arch, smoke):
    """Every SSM config, full size and smoke, takes the mma design in bf16
    and the first (SIMT) one in f32."""
    cfg = get_config(arch, smoke=smoke)
    shape = (cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    assert ssd_scan_design(torch.bfloat16, *shape) == "mma"
    assert ssd_scan_design(torch.float32, *shape) == "simt"


def test_k5_design_covers_every_built_bf16_shape():
    for hp in SUPPORTED_HP:
        for ns in SUPPORTED_NS:
            for chunk in SUPPORTED_CHUNK:
                assert ssd_scan_design(torch.bfloat16, hp, ns, chunk) == "mma"
                assert ssd_scan_design(torch.float32, hp, ns, chunk) == "simt"


def test_cpu_call_runs_the_plain_version_and_launches_nothing():
    x, B, C, dt, A = _torch(*_inputs(2, 100, 2, 32, 16, seed=4))
    lens = torch.tensor([100, 40])
    build.reset_launch_counts()
    y, h = ops.ssd_scan(x, B, C, dt, A, 32, lengths=lens)
    yp, hp = ref.ssd_scan_ref(x, B, C, dt, A, 32, lengths=lens)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert all(v == 0 for v in build.launch_counts().values())


def test_k5_launch_counts_and_the_prev_yardstick():
    """``ssd_scan`` counts every K5 launch, ``ssd_scan_mma`` the new
    design's, ``ssd_scan_prev`` the first design's yardstick launches, which
    refuse CPU tensors."""
    for name in ("ssd_scan", "ssd_scan_mma", "ssd_scan_prev"):
        assert name in build.launch_counts()
    x, B, C, dt, A = _torch(*_inputs(1, 32, 1, 32, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_scan_prev(x, B, C, dt, A, 32)
