"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Without a CUDA device every test skips (CUDA kernels have no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import SPLIT_SLOTS, decode_attention_prev  # noqa: E402
from repro_torch.kernels.expert_gemm import (  # noqa: E402
    expert_gate_up_prev,
    grouped_matmul_prev,
)


def assert_close(got, want, tol_f32=2e-5):
    """f32: within 2e-5 absolute (tests/test_kernels.py's TOL), on outputs of
    order 0.1.  bf16: every row of the last axis within 0.02 of that row's
    largest reference value (one bf16 rounding flip is at most 2**-7 of it;
    an all-zero reference row must be matched exactly)."""
    d = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert d.max() < tol_f32, float(d.max())
    else:
        peak = want.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        rel = (d.amax(-1) / peak).max()
        assert rel < 0.02, float(rel)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [(4, 64, 256, 128), (3, 100, 256, 200),
                                     (2, 70, 100, 60)])      # no 16-byte vectors
def test_cuda_expert_ffn_matches_plain(cuda, dtype, E, C, D, F):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn((E, C, D), generator=g, device=cuda) * 0.3).to(dtype)
    ws = [(torch.randn(s, generator=g, device=cuda) * s[1] ** -0.5).to(dtype)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    counts = torch.tensor([C, 0, 7, 63][:E], dtype=torch.int32, device=cuda)
    got = ops.grouped_expert_ffn(x, *ws, counts)
    want = ref.expert_ffn_ref(x, *ws, counts)
    assert_close(got, want)


def _gm_inputs(cuda, E, C, K, N, counts):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((E, C, K), generator=g, device=cuda) * 0.3
    w = torch.randn((E, K, N), generator=g, device=cuda) * K ** -0.5
    if counts == "routed":                     # 64 tokens x top-8 of E experts
        picks = torch.rand((64, E), generator=g, device=cuda).argsort(dim=1)[:, :8]
        counts = torch.bincount(picks.reshape(-1), minlength=E).clamp(max=C).tolist()
    cnt = None
    if counts is not None:
        cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
        x = x * (torch.arange(C, device=cuda)[None, :] < cnt[:, None])[..., None]
    return x.bfloat16(), w.bfloat16(), cnt


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N,counts", [
    (4, 300, 1024, 2048, [0, 1, 63, 64]),          # C not a multiple of 128
    (4, 300, 1024, 2048, [127, 128, 129, 300]),    # tile edges, and C itself
    (3, 200, 256, 200, [200, 5, 0]),               # N % 8 == 0, not a multiple of 256
    (2, 130, 72, 136, [130, 77]),                  # K not a multiple of 64
    (2, 200, 256, 512, None),                      # no counts: every row live
    (64, 64, 1024, 2048, "routed"),                # the decode shape (64-row tiles)
    (64, 64, 1024, 2048, [64] * 64),               # ...every row live
])
def test_cuda_grouped_matmul_wgmma_tile_edges(cuda, E, C, K, N, counts):
    """K2's wgmma design against its plain version and the first design:
    rows within 0.02 of their peak, rows past counts exactly zero."""
    x, w, cnt = _gm_inputs(cuda, E, C, K, N, counts)
    build.reset_launch_counts()
    got = ops.grouped_matmul(x, w, cnt)
    assert build.launch_counts()["grouped_matmul_wgmma"] == 1
    want = ref.grouped_matmul_ref(x, w, cnt)
    assert_close(got, want)
    assert_close(grouped_matmul_prev(x, w, cnt), want)
    for e, n in enumerate([C] * E if cnt is None else cnt.tolist()):
        assert torch.count_nonzero(got[e, n:]) == 0


@pytest.mark.cuda
def test_cuda_grouped_matmul_unaligned_rows_take_the_wmma_design(cuda):
    """Rows of 120 and 200 bytes, which TMA cannot address: the first design."""
    x, w, cnt = _gm_inputs(cuda, 2, 70, 60, 100, [70, 9])
    build.reset_launch_counts()
    got = ops.grouped_matmul(x, w, cnt)
    counts = build.launch_counts()
    assert counts["grouped_matmul"] == 1 and counts["grouped_matmul_wgmma"] == 0
    assert_close(got, ref.grouped_matmul_ref(x, w, cnt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,hd,S", [(4, 16, 16, 128, 512), (4, 32, 8, 128, 300),
                                        (2, 4, 2, 32, 64)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, B, H, K, hd, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, S, (B,), generator=g, device=cuda, dtype=torch.int32)
    got = ops.decode_attention(q, k, v, pos)
    want = ref.decode_attention_ref(q, k, v, pos)
    assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,D,F,counts", [
    (4, 300, 1024, 2048, [0, 1, 127, 300]),        # C not a multiple of 128, tile edges
    (3, 200, 256, 200, [500, 5, 0]),               # counts above C; F % 128 != 0
    (2, 130, 72, 136, [130, 77]),                  # D not a multiple of 64
    (2, 200, 256, 512, None),                      # no counts: every row live
    (3, 40, 256, 200, [40, 0, 17]),                # decode (C <= 64), F % 64 != 0
    (4, 64, 256, 128, [16, 17, 33, 64]),           # decode: live rows at 16-row edges
    (64, 64, 2048, 1024, "routed"),                # the OLMoE decode shape
    (64, 64, 2048, 1024, [64] * 64),               # ...every row live
])
def test_cuda_expert_gate_up_wgmma_edges(cuda, E, C, D, F, counts):
    """K1's wgmma design against its plain version and the first design:
    rows within 0.02 of their peak, rows past counts exactly zero, and dead
    rows of x set to NaN change no bit."""
    x, wg, cnt = _gm_inputs(cuda, E, C, D, F, counts)
    g = torch.Generator(device=cuda).manual_seed(1)
    wu = (torch.randn((E, D, F), generator=g, device=cuda) * D ** -0.5).bfloat16()
    build.reset_launch_counts()
    got = ops.expert_gate_up(x, wg, wu, cnt)
    assert build.launch_counts()["expert_gate_up_wgmma"] == 1
    want = ref.expert_gate_up_ref(x, wg, wu, cnt)
    assert_close(got, want)
    assert_close(expert_gate_up_prev(x, wg, wu, cnt), want)
    if cnt is not None:
        for e, n in enumerate(cnt.tolist()):
            assert torch.count_nonzero(got[e, n:]) == 0
        dead = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
        x_nan = torch.where(dead[..., None], torch.full_like(x, float("nan")), x)
        assert torch.equal(ops.expert_gate_up(x_nan, wg, wu, cnt), got)


def _decode_inputs(cuda, B, H, K, hd, S, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 255, 256, 257, 3648])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_split_matches_plain(cuda, dtype, G, hd, S):
    """K3 against its plain version at rows ending on slot 0, the split edges
    (L - 1, L) and the last slot, with keys past pos set to 1e4 and values
    to NaN: bf16 takes the split design, f32 the first one."""
    B, K = 4, 2
    q, k, v = _decode_inputs(cuda, B, K * G, K, hd, S, dtype)
    L = SPLIT_SLOTS
    pos = torch.tensor([0, min(S - 1, L - 1), min(S - 1, L), S - 1], dtype=torch.int32,
                       device=cuda)
    build.reset_launch_counts()
    got = ops.decode_attention(q, k, v, pos)
    assert build.launch_counts()["decode_attention_split"] == int(dtype == torch.bfloat16)
    assert_close(got, ref.decode_attention_ref(q, k, v, pos))
    dead = torch.arange(S, device=cuda)[None, :, None, None] > pos[:, None, None, None]
    k2 = torch.where(dead, torch.full_like(k, 1e4), k)
    v2 = torch.where(dead, torch.full_like(v, float("nan")), v)
    assert torch.equal(ops.decode_attention(q, k2, v2, pos), got)
    assert_close(decode_attention_prev(q, k, v, pos), ref.decode_attention_ref(q, k, v, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [288, 3648])
def test_cuda_decode_attention_split_batch_invariant(cuda, S):
    """A row's output is bit-identical alone, inside a batch of 32 and at
    another row of another batch: the split partition depends on S alone."""
    B, H, K, hd = 32, 16, 16, 128
    q, k, v = _decode_inputs(cuda, B, H, K, hd, S, torch.bfloat16)
    pos = torch.arange(B, device=cuda, dtype=torch.int32) * (S // B) + S % B
    got = ops.decode_attention(q, k, v, pos)
    r = 5
    alone = ops.decode_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1], pos[r:r + 1])
    assert torch.equal(alone[0], got[r])
    q2, k2, v2 = _decode_inputs(cuda, B, H, K, hd, S, torch.bfloat16, seed=7)
    pos2 = torch.flip(pos, [0])
    q2[20], k2[20], v2[20], pos2[20] = q[r], k[r], v[r], pos[r]
    assert torch.equal(ops.decode_attention(q2, k2, v2, pos2)[20], got[r])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_negative_pos_writes_zeros(cuda, dtype):
    q, k, v = _decode_inputs(cuda, 3, 8, 4, 128, 300, dtype)
    pos = torch.tensor([-1, 299, -7], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, pos)
    assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[2]) == 0
    assert_close(got[1:2], ref.decode_attention_ref(q[1:2], k[1:2], v[1:2], pos[1:2]))


def _flash_inputs(cuda, B, S, H, K, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,window,lengths", [
    (2, 300, 4, 4, 128, 0, [300, 131]),        # ragged, lengths % 64 != 0
    (4, 200, 8, 2, 64, 0, [200, 1, 64, 129]),  # lengths[b] == 1, a tile edge
    (2, 513, 8, 1, 128, 100, [513, 260]),      # window + lengths + G = 8
    (1, 256, 4, 1, 64, 0, None),               # no lengths, S a tile multiple
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, S, H, K, hd, window, lengths):
    q, k, v = _flash_inputs(cuda, B, S, H, K, hd, dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda,
                                                     dtype=torch.int32)
    got = ops.flash_attention(q, k, v, window=window, lengths=lens)
    want = ref.flash_attention_ref(q, k, v, window=window, lengths=lens)
    assert_close(got, want)
    if lengths is not None:                    # rows past lengths are zeros
        for b, n in enumerate(lengths):
            assert torch.count_nonzero(got[b, n:]) == 0


@pytest.mark.cuda
def test_cuda_flash_attention_poisoned_keys(cuda):
    """Keys and values past lengths[b] set to 1e4 change no valid row."""
    B, S, H, K, hd = 3, 333, 8, 2, 128
    q, k, v = _flash_inputs(cuda, B, S, H, K, hd, torch.bfloat16)
    lens = torch.tensor([333, 100, 7], device=cuda, dtype=torch.int32)
    base = ops.flash_attention(q, k, v, lengths=lens)
    dead = torch.arange(S, device=cuda)[None, :, None, None] >= lens[:, None, None, None]
    k2 = torch.where(dead, torch.full_like(k, 1e4), k)
    v2 = torch.where(dead, torch.full_like(v, 1e4), v)
    assert torch.equal(ops.flash_attention(q, k2, v2, lengths=lens), base)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_cuda_flash_attention_wgmma_edges(cuda, G, hd, window):
    """K4's wgmma design: S a multiple of neither the 128-row query tile nor
    the 64-key tile, lengths of 1 and of exactly one query tile, a window
    crossing key tiles, and keys past lengths set to 1e4 changing no bit."""
    B, S, K = 3, 333, 2
    q, k, v = _flash_inputs(cuda, B, S, G * K, K, hd, torch.bfloat16)
    lens = torch.tensor([333, 1, 128], device=cuda, dtype=torch.int32)
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window, lengths=lens)
    assert build.launch_counts()["flash_attention_wgmma"] == 1
    assert_close(got, ref.flash_attention_ref(q, k, v, window=window, lengths=lens))
    for b, n in enumerate(lens.tolist()):
        assert torch.count_nonzero(got[b, n:]) == 0
    dead = torch.arange(S, device=cuda)[None, :, None, None] >= lens[:, None, None, None]
    k2 = torch.where(dead, torch.full_like(k, 1e4), k)
    v2 = torch.where(dead, torch.full_like(v, 1e4), v)
    assert torch.equal(ops.flash_attention(q, k2, v2, window=window, lengths=lens), got)


@pytest.mark.cuda
def test_cuda_flash_attention_hd32_takes_the_mma_design(cuda):
    q, k, v = _flash_inputs(cuda, 2, 100, 4, 2, 32, torch.bfloat16)
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    counts = build.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_wgmma"] == 0
    assert_close(got, ref.flash_attention_ref(q, k, v))


def _ssd_inputs(cuda, Bt, S, nh, hp, ns, dtype):
    """tests/test_kernels.py's SSD inputs: x, B, C at scale 0.5,
    dt = softplus(normal), A = -exp(0.3 normal)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, B, C = [(torch.randn(s, generator=g, device=cuda) * 0.5).to(dtype)
               for s in ((Bt, S, nh, hp), (Bt, S, ns), (Bt, S, ns))]
    dt = torch.nn.functional.softplus(torch.randn((Bt, S, nh), generator=g, device=cuda))
    A = -torch.exp(torch.randn((nh,), generator=g, device=cuda) * 0.3)
    return x, B, C, dt, A


def assert_state_close(got, want):
    """The f32 state: each (row, head) slice within 1e-4 of its largest
    reference value (the state update stays in f32)."""
    d = (got - want).abs().amax((-2, -1))
    peak = want.abs().amax((-2, -1)).clamp_min(torch.finfo(torch.float32).tiny)
    assert float((d / peak).max()) < 1e-4, float((d / peak).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,nh,hp,ns,chunk,lengths", [
    (2, 256, 4, 32, 16, 64, None),                 # tests/test_kernels.py's shape
    (2, 128, 8, 32, 16, 32, [128, 1]),             # the smoke configs' chunk, length 1
    (3, 300, 4, 64, 128, 256, [300, 256, 1]),      # S % chunk != 0, one whole chunk
    (2, 200, 2, 64, 64, 128, [77, 200]),
])
def test_cuda_ssd_scan_matches_plain(cuda, dtype, Bt, S, nh, hp, ns, chunk, lengths):
    """K5 against its plain version: y in f32 within 8e-5 absolute
    (tests/test_kernels.py's 4 x TOL for this kernel), bf16 rows within 0.02
    of their peak; rows past lengths exactly zero; the f32 state."""
    x, B, C, dt, A = _ssd_inputs(cuda, Bt, S, nh, hp, ns, dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda,
                                                     dtype=torch.int32)
    y, h = ops.ssd_scan(x, B, C, dt, A, chunk, lengths=lens)
    y_ref, h_ref = ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lens)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert_close(y, y_ref, tol_f32=8e-5)
    assert_state_close(h, h_ref)
    for b, n in enumerate(lengths or []):
        assert torch.count_nonzero(y[b, n:]) == 0


@pytest.mark.cuda
def test_cuda_ssd_scan_poisoned_padding(cuda):
    """x, B and C past lengths[b] set to 1e4 change no valid row and not the
    state."""
    Bt, S, nh, hp, ns, chunk = 3, 300, 4, 64, 128, 256
    x, B, C, dt, A = _ssd_inputs(cuda, Bt, S, nh, hp, ns, torch.bfloat16)
    lens = torch.tensor([300, 100, 7], device=cuda, dtype=torch.int32)
    y, h = ops.ssd_scan(x, B, C, dt, A, chunk, lengths=lens)
    dead = torch.arange(S, device=cuda)[None, :] >= lens[:, None]
    x2 = torch.where(dead[..., None, None], torch.full_like(x, 1e4), x)
    B2 = torch.where(dead[..., None], torch.full_like(B, 1e4), B)
    C2 = torch.where(dead[..., None], torch.full_like(C, 1e4), C)
    y2, h2 = ops.ssd_scan(x2, B2, C2, dt, A, chunk, lengths=lens)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda):
    """The engine on the card (kernels) against the same engine on the CPU
    (plain versions), f32, smoke olmoe: logits within 1e-4 of their scale
    and identical greedy tokens."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import model as M

    cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12))
    lens = np.array([12, 9, 5, 12])
    out = {}
    for dev in ("cpu", cuda):
        eng = ModuleBatchingEngine(cfg, params, Plan(B=4, b_a=2, b_e=3), max_seq=20,
                                   device=dev)
        lg = eng.prefill(toks, lengths=lens).cpu()
        gen = eng.generate(toks, 6, lengths=lens).cpu()
        out[str(dev)] = (lg, gen)
    scale = float(out["cpu"][0].abs().max())
    assert float((out["cpu"][0] - out["cuda"][0]).abs().max()) / scale < 1e-4
    assert torch.equal(out["cpu"][1], out["cuda"][1])
