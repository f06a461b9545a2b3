"""The port's CUDA kernels against their plain PyTorch versions, and the
fused decode chunk's CUDA graph against eager per-module ticks, on a card.

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
from repro_torch.kernels.ssd_scan import ssd_scan_prev  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,q_offset,H,K,hd,lengths", [
    (1, 16, 1024, 16, 16, 128, None),          # serve_prefix's shortest suffix
    (1, 128, 1024, 32, 8, 128, None),          # Mixtral's GQA, a whole query tile
    (1, 64, 1000, 8, 2, 64, None),             # an offset on no tile edge
    (2, 100, 300, 8, 1, 128, [400, 333]),      # absolute lengths, G = 8
    (2, 20, 45, 4, 2, 32, None),               # hd 32: the first (mma) design
])
def test_cuda_flash_attention_q_offset_matches_plain(cuda, dtype, B, Sq, q_offset, H, K, hd,
                                                     lengths):
    """K4 with a query offset (a prefix-cache hit's suffix prefill) in every
    design against its plain version, query rows past lengths zero, and the
    same rows of a full causal call over the whole sequence within the
    same tolerance."""
    g = torch.Generator(device=cuda).manual_seed(1)
    Sk = q_offset + Sq
    q, k, v = [torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]
    lens = None if lengths is None else torch.tensor(lengths, device=cuda, dtype=torch.int32)
    build.reset_launch_counts()
    got = ops.flash_attention(q, k, v, lengths=lens, q_offset=q_offset)
    wgmma = dtype == torch.bfloat16 and hd in (64, 128)
    assert build.launch_counts()["flash_attention_wgmma"] == int(wgmma)
    assert_close(got, ref.flash_attention_ref(q, k, v, lengths=lens, q_offset=q_offset))
    for b, n in enumerate(lengths or []):
        assert torch.count_nonzero(got[b, max(0, n - q_offset):]) == 0
    q_full = torch.cat([torch.randn((B, q_offset, H, hd), generator=g, device=cuda).to(dtype),
                        q], dim=1)
    assert_close(got, ops.flash_attention(q_full, k, v, lengths=lens)[:, q_offset:])


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


# K5 through the served wrapper (bf16: the mma design, f32: the first) and
# through the first design's yardstick, with the launch counter each adds to
K5_ENTRIES = {"ssd_scan": ops.ssd_scan, "ssd_scan_prev": ssd_scan_prev}


def _k5_counted(which, dtype):
    if which == "ssd_scan_prev":
        return "ssd_scan_prev"
    return "ssd_scan_mma" if dtype == torch.bfloat16 else "ssd_scan"


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(K5_ENTRIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,S,nh,hp,ns,chunk,lengths", [
    (2, 256, 4, 32, 16, 64, None),                 # tests/test_kernels.py's shape
    (2, 128, 8, 32, 16, 32, [128, 1]),             # the smoke configs' chunk, length 1
    (3, 300, 4, 64, 128, 256, [300, 256, 1]),      # S % chunk != 0, one whole chunk
    (2, 200, 2, 64, 64, 128, [77, 200]),
    (2, 300, 2, 32, 128, 256, [300, 129]),         # hp 32 at ns 128
    (2, 100, 2, 64, 16, 32, [100, 33]),            # hp 64 at ns 16
    (2, 160, 2, 32, 64, 64, [160, 100]),           # hp 32 at ns 64
    (2, 300, 2, 64, 128, 64, [300, 65]),           # Mamba2's widths at chunk 64
])
def test_cuda_ssd_scan_matches_plain(cuda, which, dtype, Bt, S, nh, hp, ns, chunk, lengths):
    """K5 against its plain version: y in f32 within 8e-5 absolute
    (tests/test_kernels.py's 4 x TOL for this kernel), bf16 rows within 0.02
    of their peak; rows past lengths exactly zero; the f32 state.  The mma
    design is also held to its CPU mirror (``ref.ssd_scan_mma_ref``), and
    each call must have launched the design its dtype selects."""
    x, B, C, dt, A = _ssd_inputs(cuda, Bt, S, nh, hp, ns, dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda,
                                                     dtype=torch.int32)
    build.reset_launch_counts()
    y, h = K5_ENTRIES[which](x, B, C, dt, A, chunk, lengths=lens)
    counts = build.launch_counts()
    assert counts[_k5_counted(which, dtype)] == 1 and sum(counts.values()) == (
        2 if which == "ssd_scan" and dtype == torch.bfloat16 else 1), counts
    y_ref, h_ref = ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lens)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert_close(y, y_ref, tol_f32=8e-5)
    assert_state_close(h, h_ref)
    if which == "ssd_scan" and dtype == torch.bfloat16:
        y_mir, h_mir = ref.ssd_scan_mma_ref(x, B, C, dt, A, chunk, lengths=lens)
        assert_close(y, y_mir)
        assert_state_close(h, h_mir)
    for b, n in enumerate(lengths or []):
        assert torch.count_nonzero(y[b, n:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(K5_ENTRIES))
@pytest.mark.parametrize("poison", [1e4, float("nan")])
def test_cuda_ssd_scan_poisoned_padding(cuda, which, poison):
    """x, B, C and dt past lengths[b] set to 1e4 or NaN change no bit of y
    or of the state."""
    Bt, S, nh, hp, ns, chunk = 3, 300, 4, 64, 128, 256
    x, B, C, dt, A = _ssd_inputs(cuda, Bt, S, nh, hp, ns, torch.bfloat16)
    lens = torch.tensor([300, 100, 7], device=cuda, dtype=torch.int32)
    fn = K5_ENTRIES[which]
    y, h = fn(x, B, C, dt, A, chunk, lengths=lens)
    dead = torch.arange(S, device=cuda)[None, :] >= lens[:, None]
    x2 = torch.where(dead[..., None, None], torch.full_like(x, poison), x)
    B2 = torch.where(dead[..., None], torch.full_like(B, poison), B)
    C2 = torch.where(dead[..., None], torch.full_like(C, poison), C)
    dt2 = torch.where(dead[..., None], torch.full_like(dt, poison), dt)
    y2, h2 = fn(x2, B2, C2, dt2, A, chunk, lengths=lens)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,hp,chunk", [(128, 64, 256), (16, 32, 32)])
def test_cuda_ssd_scan_mma_batch_invariant(cuda, ns, hp, chunk):
    """A row run alone, at S equal to its length, is bit-identical (y and
    state) to the same row inside a ragged batch padded to a longer S."""
    Bt, S, nh = 4, 700, 4
    x, B, C, dt, A = _ssd_inputs(cuda, Bt, S, nh, hp, ns, torch.bfloat16)
    lens = torch.tensor([700, 389, 1, 512], device=cuda, dtype=torch.int32)
    y, h = ops.ssd_scan(x, B, C, dt, A, chunk, lengths=lens)
    for b, n in enumerate(lens.tolist()):
        ya, ha = ops.ssd_scan(x[b:b + 1, :n].contiguous(), B[b:b + 1, :n].contiguous(),
                              C[b:b + 1, :n].contiguous(), dt[b:b + 1, :n].contiguous(), A,
                              chunk)
        assert torch.equal(ya[0], y[b, :n]) and torch.equal(ha[0], h[b]), b


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


# ---------------------------------------------------------------------------
# The fused decode chunk: one tick captured as a CUDA graph, replayed
# ---------------------------------------------------------------------------
def _fused_setup(cuda, arch, fused, b_a=2, n=4, max_seq=24):
    """A smoke config in its own dtype (bf16, as served) on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, seed=0, device=cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (n, 12))
    plan = Plan(B=n, b_a=b_a, b_e=n, omega=0.0, decode_chunk=8)
    return cfg, params, toks, [ModuleBatchingEngine(cfg, params, plan, max_seq=max_seq,
                                                    device=cuda, fused_decode=f)
                               for f in fused]


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_cuda_graph_ticks_match_eager_ticks(cuda, arch, sampled):
    """Replayed ticks against eager per-module ticks, bit for bit, on a
    ragged batch: one chunk of 8 replays of one captured graph."""
    import numpy as np

    from repro_torch.serving.sampling import SamplingParams

    _, _, toks, (ref, eng) = _fused_setup(cuda, arch, (False, True))
    lens = np.array([12, 9, 5, 12])
    sp = SamplingParams(0.8, 5, 13) if sampled else None
    want = ref.generate(toks, 9, lengths=lens, sampling=sp, chunk=1)
    got = eng.generate(toks, 9, lengths=lens, sampling=sp)
    assert torch.equal(got, want)
    assert (eng.stats.fused_dispatches, eng.stats.fused_ticks) == (1, 8)
    assert len(eng.graph_captures) == 1 and ref.stats.fused_dispatches == 0


@pytest.mark.cuda
def test_cuda_generate_twice_on_one_engine(cuda):
    """A second ``generate`` refills the same cache in place and replays the
    graph captured by the first; a new batch size allocates a new cache
    and captures again.  Tokens equal the per-module path's throughout."""
    _, _, toks, (ref, eng) = _fused_setup(cuda, "jamba-1.5-large-398b", (False, True))
    want = ref.generate(toks, 9, chunk=1)
    assert torch.equal(eng.generate(toks, 9), want)
    ptrs = [t.data_ptr() for layer in eng.cache for t in layer.values()]
    assert torch.equal(eng.generate(toks, 9), want)
    assert [t.data_ptr() for layer in eng.cache for t in layer.values()] == ptrs
    assert len(eng.graph_captures) == 1
    assert torch.equal(eng.generate(toks[:3], 9), ref.generate(toks[:3], 9, chunk=1))
    assert len(eng.graph_captures) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_cuda_decode_makes_no_hidden_host_sync(cuda, arch):
    """The ROADMAP contract "no hidden host syncs on the decode path": under
    ``set_sync_debug_mode("error")`` a per-module chunk and a fused chunk
    (greedy and seeded, after their graphs were captured) run without one
    host wait; the token read after each chunk is the planned one."""
    import numpy as np

    from repro_torch.serving.sampling import BatchSampler, SamplingParams

    _, _, toks, (ref, eng) = _fused_setup(cuda, arch, (False, True))
    pos = np.full(4, 12)
    outs = {}
    for name, e in (("per-module", ref), ("fused", eng)):
        cur = e.prefill(toks).argmax(-1)
        for sp in (None, SamplingParams(0.9, 3, 5)):
            e.decode_chunk(cur, pos, BatchSampler.uniform(4, sp), 4)      # captures
            sampler = BatchSampler.uniform(4, sp)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = e.decode_chunk(cur, pos, sampler, 4)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[name, sp is None] = out.cpu()
    assert all(torch.equal(outs["fused", g], outs["per-module", g]) for g in (True, False))


def _prefix_replan_server(device, n=8, B=4, decode_len=26):
    """A smoke OLMoE server (bf16 on the card) with the prefix cache and
    online re-planning on: ``n`` prompts sharing a 16-token prefix (pages of
    8), ``B`` slots, one decode tick a step, a drift threshold the seeded
    routing crosses."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.models import model as M
    from repro_torch.serving.server import Request, ServeConfig, Server

    cfg = get_config("olmoe-1b-7b", smoke=True)
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(4)
    pre = rng.integers(5, cfg.vocab_size - 5, 16)
    serve = ServeConfig(decode_len=decode_len, max_seq=64, kv_page_tokens=8, prefix_cache=True,
                        replan_skew=1e-3, replan_drop_target=0.2, decode_chunk=1)
    server = Server(cfg, params, Plan(B=B, b_a=2, b_e=B, omega=0.0, decode_chunk=1),
                    serve=serve, device=device)
    for i in range(n):
        own = rng.integers(5, cfg.vocab_size - 5, 2 + i % 5)
        server.submit(Request(np.concatenate([pre, own]).astype(np.int32), decode_len))
    server._ensure_engine()
    return server


@pytest.mark.cuda
def test_cuda_prefix_hit_and_replan_make_only_planned_syncs(cuda):
    """Two static waves (misses, then prefix hits) with re-planning on: every
    decode chunk and every re-plan check runs under
    ``set_sync_debug_mode("error")`` (a graph capture, once per key, is
    set-up and runs with the mode off), and the planned reads are the one
    prefix capture plus one per re-plan check (every 8 decode steps)."""
    import contextlib

    server = _prefix_replan_server(cuda)
    eng = server._engine

    @contextlib.contextmanager
    def mode(m):
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(m)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(old)

    def under(m, fn):
        def call(*a, **kw):
            with mode(m):
                return fn(*a, **kw)
        return call

    pushed = []
    set_capacity = eng.set_expert_capacity

    def record(b_e):
        pushed.append(b_e)
        set_capacity(b_e)

    eng.set_expert_capacity = record
    eng.decode_chunk = under("error", eng.decode_chunk)
    eng._graph = under(0, eng._graph)
    server._maybe_replan = under("error", server._maybe_replan)
    rep = server.run()
    steps = rep.decode_slot_steps // server._b
    assert (rep.prefix_misses, rep.prefix_hits) == (4, 4)
    assert rep.capacity_replans == len(pushed) >= 1 and steps == 50
    assert eng.stats.planned_reads == 1 + steps // 8
    # one graph capture per distinct capacity (every push is followed by ticks)
    capacities = [c["key"]["capacity"] for c in eng.graph_captures]
    assert len(capacities) == len(set(capacities))
    assert set(capacities) == {server._b} | set(pushed)


@pytest.mark.cuda
def test_cuda_replays_add_the_captured_launches(cuda):
    """``build.LAUNCHES`` after N replays equals N times the launches the
    capture recorded: a first chunk of one tick (warm-up, capture, one
    replay) counts one replay.  The graph's memory pool holds segments."""
    import numpy as np

    from repro_torch.serving.sampling import BatchSampler

    cfg, _, toks, (eng,) = _fused_setup(cuda, "jamba-1.5-large-398b", (True,))
    cur = eng.prefill(toks).argmax(-1)
    ops.reset_launch_counts()
    eng.decode_chunk(cur, np.full(4, 12), BatchSampler.uniform(4, None), 1)
    delta = eng.graph_captures[0]["launches_per_replay"]
    assert ops.launch_counts() == {k: delta.get(k, 0) for k in ops.launch_counts()}
    assert eng.graph_captures[0]["pool_bytes"] > 0
    n_moe = sum(1 for _, f in eng.schema if f == "moe")
    n_attn = sum(1 for k, _ in eng.schema if k == "attn")
    assert delta["expert_gate_up"] == delta["grouped_matmul"] == n_moe > 0
    assert delta["decode_attention"] == n_attn * 2 > 0          # b_a 2 of B 4
    assert "flash_attention" not in delta and "ssd_scan" not in delta
    ops.reset_launch_counts()
    eng.decode_chunk(cur, np.full(4, 12), BatchSampler.uniform(4, None), 7)
    assert ops.launch_counts() == {k: 7 * delta.get(k, 0) for k in ops.launch_counts()}


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda, monkeypatch):
    """A tick that cannot be captured (here: a host read inside it) raises
    from the engine; nothing falls back to eager launches."""
    import numpy as np

    from repro_torch.models import attention as attn_mod
    from repro_torch.serving.sampling import BatchSampler

    _, _, toks, (eng,) = _fused_setup(cuda, "olmoe-1b-7b", (True,))
    cur = eng.prefill(toks).argmax(-1)
    real = attn_mod.ops.decode_attention

    def reads_the_host(q, k, v, pos):
        float(q.float().sum())
        return real(q, k, v, pos)

    monkeypatch.setattr(attn_mod.ops, "decode_attention", reads_the_host)
    with pytest.raises(RuntimeError):
        eng.decode_chunk(cur, np.full(4, 12), BatchSampler.uniform(4, None), 2)
    assert eng.stats.fused_dispatches == 0 and not eng.graph_captures


# ---------------------------------------------------------------------------
# Weight streaming: page-locked host memory, the copy stream, the window
# ---------------------------------------------------------------------------
def _olmoe_4_layers(cuda, n=8, S=48):
    """OLMoE-1B-7B at full width and 4 layers, bf16, seeded, on the card;
    ragged prompts; the plan's b_e = B so nothing drops."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import workload as W
    from repro_torch.core.dag_builder import Plan
    from repro_torch.models import model as M

    cfg = replace(get_config("olmoe-1b-7b"), num_layers=4)
    params = M.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (n, S))
    lens = rng.integers(S // 2, S + 1, n)
    plan = Plan(B=n, b_a=4, b_e=n, omega=0.0, decode_chunk=4)
    # the base and every mixer resident, one expert stack, three streamed
    budget = (W.base_weight_bytes(cfg) + 4 * W.mixer_weight_bytes(cfg, "attn")
              + W.ffn_module_weight_bytes(cfg, "moe"))
    return cfg, params, toks, lens, plan, budget


def _streamed(cfg, params, plan, cuda, budget, **kw):
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.weights import ParamStore

    store = ParamStore(cfg, params, resident_bytes=budget, device=cuda, **kw)
    return ModuleBatchingEngine(cfg, None, plan, max_seq=64, store=store, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"prefetch": False}, {"predict_topk": 2},
                                {"predict_topk": 2, "lru_bytes": 1e9}],
                         ids=["prefetch", "serial", "predictive", "predictive-lru"])
def test_cuda_streamed_olmoe_matches_resident(cuda, kw):
    """Full-width OLMoE, 4 layers, 3 expert stacks in page-locked host
    memory: the streamed engine's tokens equal the resident (fused)
    engine's bit for bit, with the bytes the plan reckons."""
    from repro_torch.core.engine import ModuleBatchingEngine

    cfg, params, toks, lens, plan, budget = _olmoe_4_layers(cuda)
    want = ModuleBatchingEngine(cfg, params, plan, max_seq=64,
                                device=cuda).generate(toks, 9, lengths=lens)
    eng = _streamed(cfg, params, plan, cuda, budget, **kw)
    assert not eng.fused_eligible() and eng.store.streamed_module_bytes() > 0
    got = eng.generate(toks, 9, lengths=lens)
    assert torch.equal(got, want)
    assert eng.stats.fused_dispatches == 0 and eng.stats.weight_htod_bytes > 0
    if not kw:
        # 3 stacks a prefill and a decode tick (8 ticks), the wrapped
        # prefetch of the first streamed layer included
        stack = eng.store._host[1].layout.nbytes
        assert eng.stats.weight_htod_bytes == 3 * stack * 9


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_cuda_window_slot_reuse_waits_for_a_slow_consumer(cuda, depth, monkeypatch):
    """The slot-reuse hazard: every grouped FFN first spins the compute
    stream (a slow consumer), so a prefetch that overwrote a slot still
    being read would change the tokens.  A window of depth 1 (the next
    layer's copy must wait for the one slot) and of depth 2 give the
    resident tokens."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import moe as moe_mod

    cfg, params, toks, lens, plan, budget = _olmoe_4_layers(cuda)
    want = ModuleBatchingEngine(cfg, params, plan, max_seq=64,
                                device=cuda).generate(toks, 5, lengths=lens)
    real = moe_mod.ops.grouped_expert_ffn

    def slow(*args, **kw):
        torch.cuda._sleep(20_000_000)            # ~10 ms of the compute stream
        return real(*args, **kw)

    monkeypatch.setattr(moe_mod.ops, "grouped_expert_ffn", slow)
    eng = _streamed(cfg, params, plan, cuda, 0.0, prefetch_depth=depth)
    assert len(eng.store._window._slots) == depth
    assert torch.equal(eng.generate(toks, 5, lengths=lens), want)


@pytest.mark.cuda
@pytest.mark.parametrize("khat", [0, 2], ids=["whole-stack", "predictive"])
def test_cuda_streamed_decode_makes_no_hidden_host_sync(cuda, khat):
    """The "no hidden host syncs" contract on a streamed per-module chunk:
    under ``set_sync_debug_mode("error")`` the copies, the waits on them and
    the slot releases make no host wait; the predictive stage's reads are
    the planned ones, exactly one per predictive layer and tick."""
    import numpy as np

    from repro_torch.serving.sampling import BatchSampler

    cfg, params, toks, lens, plan, budget = _olmoe_4_layers(cuda)
    eng = _streamed(cfg, params, plan, cuda, budget, predict_topk=khat)
    cur = eng.prefill(toks, lengths=lens).argmax(-1)
    eng.decode_chunk(cur, lens, BatchSampler.uniform(8, None), 2)        # warm
    n_pred = sum(eng.store.streams_experts(li) for li in range(cfg.num_layers))
    reads = eng.stats.planned_reads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.decode_chunk(cur, np.asarray(lens), BatchSampler.uniform(8, None), 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (8, 4)
    assert eng.stats.planned_reads - reads == 4 * n_pred
    assert (n_pred > 0) == (khat > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("khat", [0, 2], ids=["whole-stack", "predictive"])
def test_cuda_deleted_streamed_server_frees_device_and_pinned_memory(cuda, khat):
    """A streamed server, deleted without ``gc.collect()``, returns the
    card's allocated bytes (window slots, stacks, LRU, cache) and the
    page-locked host bytes to their values before it was built."""
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving import weights as weights_mod
    from repro_torch.serving.server import ServeConfig, Server, StreamConfig

    cfg, params, _, _, plan, budget = _olmoe_4_layers(cuda)
    reqs = synthetic_requests(DatasetSpec("t", 8, 48, 4), cfg.vocab_size,
                              prompt_lens=[24, 48, 33, 40])

    def serve():
        server = Server(cfg, params, plan, serve=ServeConfig(decode_len=4),
                        stream=StreamConfig(stream_weights=True, resident_bytes=budget,
                                            predict_topk=khat), device=cuda)
        for r in reqs:
            server.submit(r)
        rep = server.run()
        assert rep.htod_gb > 0 and weights_mod.pinned_bytes() > pinned
        return server, rep

    pinned = weights_mod.pinned_bytes()
    server, _ = serve()                  # warm: library handles, K3's tickets
    del server
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    server, rep = serve()
    assert rep.expert_tokens_dropped == 0
    del server
    assert torch.cuda.memory_allocated() == before
    assert weights_mod.pinned_bytes() == pinned


# ---------------------------------------------------------------------------
# K3p, the paged decode attention, and the omega / paged engine
# ---------------------------------------------------------------------------
def _paged_inputs(cuda, n, H, K, hd, span, pt, dtype, win_frac=0.5, seed=0):
    """A device pool and a window holding ``win_frac`` of n rows' frames,
    the rows' frames shuffled over both."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pages = -(-span // pt)
    Hf = int(n * pages * win_frac)
    P = n * pages - Hf

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda).to(dtype)

    pk, pv = rand(P + 1, pt, K, hd), rand(P + 1, pt, K, hd)
    ek, ev = (rand(Hf, pt, K, hd), rand(Hf, pt, K, hd)) if Hf else (None, None)
    ids = torch.randperm(n * pages, generator=torch.Generator().manual_seed(seed))
    frames = torch.where(ids < P, ids, ids + 1).reshape(n, pages).to(torch.int32).to(cuda)
    return rand(n, H, hd), pk, pv, ek, ev, frames


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pt,span,ring", [(4, 300, False), (8, 520, False), (128, 3648, False),
                                          (8, 256, True)])
def test_cuda_decode_attention_paged_bit_identical_to_k3(cuda, dtype, pt, span, ring):
    """K3p against K3 on the gathered contiguous copy, bit for bit (same
    design, same sums), and against its plain version; a ring (positions past
    the span: every slot valid) and a dead row (pos -1: zeros)."""
    n = 6
    q, pk, pv, ek, ev, frames = _paged_inputs(cuda, n, 16, 16, 128, span, pt, dtype)
    pos = torch.tensor([span + 40, span - 1, 0, -1, 255, 1000] if ring
                       else [span - 1, 0, SPLIT_SLOTS - 1, -1, SPLIT_SLOTS, span // 2],
                       dtype=torch.int32, device=cuda)
    build.reset_launch_counts()
    got = ops.decode_attention_paged(q, pk, pv, ek, ev, frames, pos, span)
    counts = build.launch_counts()
    gk = ref.gather_pages(pk, ek, frames, span).contiguous()
    gv = ref.gather_pages(pv, ev, frames, span).contiguous()
    assert torch.equal(got, ops.decode_attention(q, gk, gv, pos))
    assert counts["decode_attention_paged"] == 1
    assert counts["decode_attention_paged_split"] == int(dtype == torch.bfloat16)
    live = pos >= 0
    want = ref.decode_attention_paged_ref(q, pk, pv, ek, ev, frames, pos, span)
    assert_close(got[live], want[live])
    assert int(torch.count_nonzero(got[~live])) == 0


@pytest.mark.cuda
def test_cuda_decode_attention_paged_pool_only_and_smoke_width(cuda):
    """No window (every frame in the pool), and the smoke configs' hd 32."""
    q, pk, pv, _, _, frames = _paged_inputs(cuda, 4, 16, 16, 128, 300, 8, torch.bfloat16,
                                            win_frac=0.0)
    pos = torch.tensor([299, 7, 150, 0], dtype=torch.int32, device=cuda)
    got = ops.decode_attention_paged(q, pk, pv, None, None, frames, pos, 300)
    gk = ref.gather_pages(pk, None, frames, 300).contiguous()
    gv = ref.gather_pages(pv, None, frames, 300).contiguous()
    assert torch.equal(got, ops.decode_attention(q, gk, gv, pos))
    for dtype in (torch.float32, torch.bfloat16):
        q, pk, pv, ek, ev, frames = _paged_inputs(cuda, 4, 8, 2, 32, 100, 8, dtype)
        pos = torch.tensor([99, 3, 50, 64], dtype=torch.int32, device=cuda)
        got = ops.decode_attention_paged(q, pk, pv, ek, ev, frames, pos, 100)
        gk, gv = ref.gather_pages(pk, ek, frames, 100), ref.gather_pages(pv, ev, frames, 100)
        assert torch.equal(got, ops.decode_attention(q, gk.contiguous(), gv.contiguous(), pos))


def _paged_engine(cfg, params, plan, cuda, page_tokens=0, frac=None, fused=True):
    """An engine with a contiguous cache (page_tokens 0), Mode A (frac
    None) or Mode B with ``frac`` of the frames in the device pool."""
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.serving.cache import CacheConfig, KVPageTable

    cc = None
    if page_tokens:
        budget = None
        if frac is not None:
            probe = KVPageTable(cfg, [(cfg.layer_kind(i), cfg.ffn_kind(i))
                                      for i in range(cfg.num_layers)], plan.B, 64,
                                CacheConfig(page_tokens=page_tokens), device=cuda)
            budget = max(1.0, int(probe.total_frames * frac) * probe.frame_bytes)
        cc = CacheConfig(page_tokens=page_tokens, device_pool_bytes=budget)
    return ModuleBatchingEngine(cfg, params, plan, max_seq=64, device=cuda, cache_config=cc,
                                fused_decode=fused)


@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.0, 0.5])
def test_cuda_paged_and_omega_olmoe_match_contiguous(cuda, omega):
    """Full-width OLMoE, 4 layers, bf16: Mode B (half the frames on the
    host, 16-slot pages; and every frame on the host, 8-slot pages) and Mode
    A give the contiguous engine's tokens at the same omega, bit for bit;
    the omega engine's fused chunk gives the per-module tokens."""
    from dataclasses import replace

    cfg, params, toks, lens, plan, _ = _olmoe_4_layers(cuda)
    plan = replace(plan, omega=omega)
    want = _paged_engine(cfg, params, plan, cuda, fused=False).generate(toks, 9, lengths=lens)
    fused = _paged_engine(cfg, params, plan, cuda)
    assert torch.equal(fused.generate(toks, 9, lengths=lens), want)
    assert fused.stats.fused_dispatches > 0
    assert fused.stats.host_attn_tokens == 8 * int(round(omega * 8)) * 4
    for pt, frac in ((16, 0.5), (8, 0.0), (16, None)):
        eng = _paged_engine(cfg, params, plan, cuda, pt, frac)
        build.reset_launch_counts()
        assert torch.equal(eng.generate(toks, 9, lengths=lens), want), (pt, frac)
        assert (eng.stats.kv_htod_bytes > 0) == (frac is not None)
        if frac is not None:
            assert eng.stats.fused_dispatches == 0
            split = build.launch_counts()
            assert split["decode_attention_paged"] == split["decode_attention_paged_split"] > 0


def _mode_b_planned_reads(eng, pos, T):
    """The planned reads a Mode B per-module chunk of T ticks must make: per
    tick and attention layer, one per host micro-batch (q/k/v down) and one
    per device micro-batch holding a row whose written page is host-side."""
    import numpy as np

    pages, n = eng.pages, len(pos)
    reads = 0
    for t in range(T):
        p = np.minimum(np.asarray(pos) + t, eng.max_seq - 1)
        slot = np.minimum(p, pages.span - 1)
        f = pages.page_map[np.arange(n), slot // pages.page_tokens]
        for lo, hi, host in eng._segments(0, n):
            reads += 1 if host else int((f[lo:hi] >= pages.device_frames).any())
    return reads * eng._n_attn


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["omega", "paged", "paged-omega"])
def test_cuda_omega_and_paged_decode_make_only_planned_syncs(cuda, mode):
    """The "no hidden host syncs" contract on an omega chunk (host rows per
    module, device rows replaying the graph) and a Mode B chunk: under
    ``set_sync_debug_mode("error")`` the only host waits are the planned
    reads, and their count is exactly the reckoned one.  In Mode B each
    layer's host frames cross once a tick, all prefetched: no host row's
    write stales a prefetch into a second copy."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.serving.sampling import BatchSampler

    cfg, params, toks, lens, plan, _ = _olmoe_4_layers(cuda)
    omega = 0.0 if mode == "paged" else 0.5
    plan = replace(plan, omega=omega)
    eng = _paged_engine(cfg, params, plan, cuda, *((16, 0.5) if "paged" in mode else ()))
    cur = eng.prefill(toks, lengths=lens).argmax(-1)
    eng.decode_chunk(cur, lens, BatchSampler.uniform(8, None), 2)       # captures
    eng.sync_stats()
    reads, htod = eng.stats.planned_reads, eng.stats.kv_htod_bytes
    demand = 0 if eng.pages is None else eng.pages.demand_fetches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.decode_chunk(cur, np.asarray(lens), BatchSampler.uniform(8, None), 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (8, 4)
    if mode == "omega":
        assert eng.stats.fused_dispatches == 2
        assert eng.stats.planned_reads - reads == 4 * eng._n_attn      # b_a 4: one a layer
    else:
        assert eng.stats.fused_dispatches == 0
        assert eng.stats.planned_reads - reads == _mode_b_planned_reads(eng, lens, 4) > 0
        eng.sync_stats()
        layer_bytes = eng.pages.host_pool_bytes() // eng._n_attn
        assert eng.pages.demand_fetches == demand
        assert eng.stats.kv_htod_bytes - htod == 4 * eng._n_attn * layer_bytes > 0


@pytest.mark.cuda
@pytest.mark.parametrize("omega", [0.0, 0.5])
def test_cuda_deleted_paged_server_frees_device_and_pinned_memory(cuda, omega):
    """A Mode B server (and its omega host buffers), deleted without
    ``gc.collect()``, returns the card's allocated bytes (pools, window
    slots) and the page-locked host bytes (host frames, host rows' KV) to
    their values before it was built."""
    from dataclasses import replace

    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving import weights as weights_mod
    from repro_torch.serving.server import ServeConfig, Server

    cfg, params, _, _, plan, _ = _olmoe_4_layers(cuda)
    plan = replace(plan, omega=omega)
    reqs = synthetic_requests(DatasetSpec("t", 8, 48, 4), cfg.vocab_size,
                              prompt_lens=[24, 48, 33, 40])

    def serve():
        server = Server(cfg, params, plan,
                        serve=ServeConfig(decode_len=4, kv_page_tokens=16, device_kv_gb=0.002),
                        device=cuda)
        for r in reqs:
            server.submit(r)
        rep = server.run()
        assert rep.kv_htod_gb > 0 and weights_mod.pinned_bytes() > pinned
        return server, rep

    pinned = weights_mod.pinned_bytes()
    server, _ = serve()
    del server
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    server, rep = serve()
    assert rep.host_attn_tokens == (3 * 4 * 4 if omega else 0)
    del server
    assert torch.cuda.memory_allocated() == before
    assert weights_mod.pinned_bytes() == pinned


# ---------------------------------------------------------------------------
# Analysis and faults on the card
# ---------------------------------------------------------------------------
def _smoke_server(device, serve_kw=None, n=6, decode_len=10, seed=5, B=4, submit=True):
    """A smoke OLMoE server (bf16) and ``n`` ragged requests, submitted
    unless ``submit`` is False."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.dag_builder import Plan
    from repro_torch.models import model as M
    from repro_torch.serving.server import Request, ServeConfig, Server

    cfg = get_config("olmoe-1b-7b", smoke=True)
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(seed)
    server = Server(cfg, params, Plan(B=B, b_a=2, b_e=B, omega=0.0, decode_chunk=4),
                    serve=ServeConfig(decode_len=decode_len, max_seq=64, **(serve_kw or {})),
                    device=device)
    requests = [Request(rng.integers(5, cfg.vocab_size - 5, 6 + 3 * i).astype(np.int32),
                        decode_len - i % 3) for i in range(n)]
    if submit:
        for r in requests:
            server.submit(r)
    return server if submit else (server, requests)


def _served_tokens(server):
    return [r.tokens.tolist() for r in server.run().request_results]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "paged-k3p", "prefix-hit"])
def test_cuda_paths_are_sanitizer_clean(cuda, path):
    """Under ``sanitize(strict=True, pointers=True)`` -- host-read guard and
    ``set_sync_debug_mode("error")`` in every decode region, pointer check
    after every tick -- the fused graph chunk, the per-module path with K3p
    and a prefix-hit run serve with no violation.  The same requests served
    again by the same server, in a steady region, capture no graph and give
    the same tokens.  (The ``set_sync_debug_mode`` tests above hold the
    unarmed path.)"""
    from repro_torch import analysis

    ops.reset_launch_counts()
    with analysis.sanitize(strict=True, pointers=True) as san:
        if path == "prefix-hit":
            server = _prefix_replan_server(cuda)
            server.run()
        else:
            kw = ({"kv_page_tokens": 8, "device_kv_gb": 2e-5} if path == "paged-k3p"
                  else {"scheduler": "static"})
            server, reqs = _smoke_server(cuda, kw, submit=False)
            first = [server.submit(r) for r in reqs]
            while server.step():
                pass
            with san.steady():
                again = [server.submit(r) for r in reqs]
                while server.step():
                    pass
            assert [h.tokens for h in again] == [h.tokens for h in first]
    rep = san.report()
    assert rep["host_reads"] == [] and rep["pointer_violations"] == []
    assert rep["steady_retraces"] == {} and rep["pointer_checks"] > 0
    assert rep["planned_transfers"]["token-readback"] > 0
    counts = ops.launch_counts()
    if path == "fused":
        assert server._engine.stats.fused_ticks > 0 and server._engine.graph_captures
    if path == "paged-k3p":
        assert counts["decode_attention_paged"] > 0 and not counts["decode_attention"]
    if path == "prefix-hit":
        assert server.report.prefix_hits > 0


@pytest.mark.cuda
def test_cuda_watchdog_recovers_an_overdue_copy(cuda):
    """A copy held up on the real copy stream (a spin queued before it) is
    older than the watchdog and not done at ``acquire``: it is abandoned by
    ``Event.query`` alone, fetched again, and the consumer reads the right
    bytes; the host never waited on the copy."""
    import time

    from repro_torch import faults
    from repro_torch.serving.weights import StreamWindow, _HostBuffer

    host = _HostBuffer(1 << 20)
    host.tensor.copy_(torch.arange(1 << 20, dtype=torch.int64).to(torch.uint8))
    host.pin()

    def fetch(key, slot):
        torch.cuda._sleep(100_000_000)             # ~50 ms on the copy stream
        slot.copy_(host.tensor, non_blocking=True)
        return slot, slot.numel()

    win = StreamWindow(fetch, lambda key: 1 << 20, 1 << 20, cuda, depth=2,
                       retry=faults.RetryPolicy(watchdog_s=0.005))
    win.prefetch(0)
    time.sleep(0.01)
    t0 = time.perf_counter()
    out = win.acquire(0)
    assert time.perf_counter() - t0 < 0.04         # no host wait on the copy
    assert win.timeouts == 1 and win.copies == 2 and win.demand == 1
    assert torch.equal(out.cpu(), host.tensor)
    torch.cuda.synchronize()
    win.close()


@pytest.mark.cuda
def test_cuda_preempt_and_resume_with_live_graphs(cuda):
    """Injected preemptions on the fused path: checkpoints go to pageable
    host memory, resumes write the rows back in place, the captured graphs
    stay valid (no pointer moves, and the armed run captures exactly the
    graphs the unarmed run captures: none for a resume) and the tokens
    equal the unarmed run's."""
    from repro_torch import analysis, faults

    kw = {"scheduler": "continuous"}
    with faults.shielded():
        plain = _smoke_server(cuda, kw)
        want = _served_tokens(plain)
    server = _smoke_server(cuda, dict(kw, faults="seed=3,preempt=3"))
    with analysis.sanitize(strict=True, pointers=True) as san:
        got = _served_tokens(server)
    assert got == want
    rep = server.report
    assert rep.preemptions > 0 and rep.resumes == rep.preemptions
    assert server._engine.stats.fused_ticks > 0
    keys = [[g["key"] for g in srv._engine.graph_captures] for srv in (plain, server)]
    assert keys[1] == keys[0] and keys[0]
    assert san.report()["pointer_violations"] == [] and san.planned["ckpt-restore"] > 0


@pytest.mark.cuda
def test_cuda_demotion_mid_run_keeps_tokens(cuda):
    """Device page frames demoted to the host tier mid-run (the ladder's
    second stage, on the copy stream) change where the bytes sit, not the
    tokens: the per-module K3p path reads them through the window."""
    # 4 slots, 2 requests: 12 device frames of 32, and host frames left free
    kw = {"scheduler": "continuous", "kv_page_tokens": 8, "device_kv_gb": 1e-4,
          "max_batch": 4}
    want = _served_tokens(_smoke_server(cuda, kw, n=2))
    server = _smoke_server(cuda, kw, n=2)
    server.step()
    server.step()
    pages = server._engine.pages
    assert pages.demote_device_frames(pages.pages_per_seq) > 0
    got = _served_tokens(server)
    assert got == want


@pytest.mark.cuda
def test_cuda_store_alive_at_exit_leaves_no_error(cuda):
    """A streamed store still referenced when the interpreter exits (a
    script's module global) does not try to close itself once torch's
    modules are torn down: the process exits 0 with no ignored exception
    from ``ParamStore.__del__`` on its standard error."""
    import os
    import subprocess
    import sys

    script = (
        "from dataclasses import replace\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import workload as W\n"
        "from repro_torch.serving.weights import ParamStore\n"
        "cfg = replace(get_config('olmoe-1b-7b'), num_layers=2)\n"
        "budget = W.base_weight_bytes(cfg) + 2 * W.mixer_weight_bytes(cfg, 'attn')\n"
        "store = ParamStore.seeded(cfg, 0, resident_bytes=budget, device='cuda')\n"
        "assert store.streamed_module_bytes() > 0\n")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Exception ignored" not in out.stderr, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# Distributed serving: replicas in one process, expert-parallel ranks
# ---------------------------------------------------------------------------
def _four_layer_olmoe(cuda):
    """OLMoE smoke (bf16) at 4 layers, seeded weights on the card, and 8
    ragged prompts."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = replace(get_config("olmoe-1b-7b", smoke=True), num_layers=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(5, cfg.vocab_size - 5, 5 + 2 * i).astype(np.int32)
               for i in range(8)]
    return cfg, M.init_params(cfg, seed=0, device=cuda), prompts


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["least-loaded", "round-robin"])
def test_cuda_replicas_match_their_witnesses(cuda, policy):
    """Two replicas behind one queue on the card, the weights shared: each
    replica's tokens equal, bit for bit, a fault-free ``Server`` fed exactly
    its requests in its order at its batch; every request served once, in
    submission order."""
    from repro_torch.core.dag_builder import Plan
    from repro_torch.distributed import ReplicaServer
    from repro_torch.serving.server import Request, ServeConfig, Server

    cfg, params, prompts = _four_layer_olmoe(cuda)
    plan = Plan(B=8, b_a=4, b_e=8, omega=0.0, decode_chunk=4)
    kw = dict(scheduler="static", decode_len=6, max_seq=32)
    rs = ReplicaServer(cfg, params, 2, plan=plan, serve=ServeConfig(**kw), policy=policy,
                       device=cuda)
    for p in prompts:
        rs.submit(Request(p, 6))
    rep = rs.run()
    assert [r.index for r in rep.merged.request_results] == list(range(len(prompts)))
    for s, r in zip(rs.servers, rep.per_replica):
        witness = Server(cfg, params, plan, serve=ServeConfig(max_batch=s._b, **kw),
                         device=cuda)
        for h in s._handles:
            witness.submit(h.request)
        want = [x.tokens.tolist() for x in witness.run().request_results]
        assert [x.tokens.tolist() for x in sorted(r.request_results,
                                                  key=lambda x: x.index)] == want


@pytest.mark.cuda
def test_cuda_ep_serve_matches_the_per_module_oracle(cuda):
    """Two gloo rank processes on the one card, each owning half the
    experts: every rank's tokens equal the single-process per-module
    oracle's bit for bit; a decode step under ``set_sync_debug_mode("error")``
    and the strict sanitizer waits for the host only in its planned scopes,
    counted by tag: per MoE layer, two dispatch reads (two chunks) and three
    combine reads, one clock broadcast and one token read."""
    from repro_torch.core.dag_builder import Plan
    from repro_torch.launch import mesh
    from repro_torch.serving.server import Request, ServeConfig, Server

    import torch_ep_ranks

    cfg, params, prompts = _four_layer_olmoe(cuda)
    plan = Plan(B=8, b_a=4, b_e=8, omega=0.0, decode_chunk=8)
    oracle = Server(cfg, params, plan, serve=ServeConfig(decode_len=6), device=cuda)
    for p in prompts:
        oracle.submit(Request(p, 6))
    oracle._ensure_engine()
    oracle._engine.fused_decode = False
    want = [r.tokens.tolist() for r in oracle.run().request_results]
    outs = mesh.spawn(torch_ep_ranks.cuda_ep_rank, 2, (4, [p.tolist() for p in prompts], 6),
                      timeout_s=600.0)
    n_moe = cfg.num_layers
    for out in outs:
        assert out["tokens"] == want
        assert out["a2a_bytes"] > 0 and out["fused_ticks"] == 0
        assert out["step_host_reads"] == []
        planned = out["step_planned"]
        assert planned["ep-a2a-batch"] == 2 * n_moe
        assert planned["ep-a2a-combine"] == 3 * n_moe
        assert planned["ep-clock"] == planned["token-readback"] == 1


@pytest.mark.cuda
def test_cuda_kernel_ops_refuse_autograd(cuda):
    """On the card each kernel writes an output with no ``grad_fn``, so every
    op must raise (naming itself) when grad mode is on and an input requires
    grad; under ``no_grad`` it launches."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s, rg=True):
        return torch.randn(s, generator=g, device=cuda).bfloat16().requires_grad_(rg)

    x, wg, wu, wd = r(2, 64, 128), r(2, 128, 64), r(2, 128, 64), r(2, 64, 128)
    q3, k, v, q4 = r(2, 8, 64), r(2, 32, 2, 64), r(2, 32, 2, 64), r(2, 32, 8, 64)
    xs, bs, cs = r(1, 64, 2, 64), r(1, 64, 128), r(1, 64, 128)
    dt = torch.rand((1, 64, 2), generator=g, device=cuda).requires_grad_(True)
    A = -torch.rand((2,), generator=g, device=cuda)
    pk, pv = r(3, 16, 2, 64), r(3, 16, 2, 64)
    frames = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    calls = {
        "expert_gate_up": lambda: ops.expert_gate_up(x, wg, wu),
        "grouped_matmul": lambda: ops.grouped_matmul(x, wg),
        "grouped_expert_ffn": lambda: ops.grouped_expert_ffn(x, wg, wu, wd),
        "decode_attention": lambda: ops.decode_attention(q3, k, v, 20),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q3[:1], pk, pv, None, None, frames, 20, 32),
        "flash_attention": lambda: ops.flash_attention(q4, k, v),
        "ssd_scan": lambda: ops.ssd_scan(xs, bs, cs, dt, A, 64),
    }
    for name, call in calls.items():
        before = dict(build.LAUNCHES)
        with pytest.raises(RuntimeError, match=name):
            call()
        assert build.LAUNCHES == before, name            # refused before launching
        with torch.no_grad():
            out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert out.grad_fn is None and out.is_cuda
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sharded_prefill_runs_local_kernels_and_grads_reach_every_leaf(cuda):
    """Two gloo rank processes on the one card, a (1, 2) mesh with
    ``seq_shard``, full-width OLMoE at 2 layers in bf16: the sharded prefill
    launches K4 at 8 of 16 heads and K1 + K2 on 32 of 64 experts (the psum
    capacity path), once a layer each, every launch the served design; then
    under autograd (no kernel launched) the loss's gradient reaches every
    leaf of each rank's shares, finite and non-zero."""
    from repro_torch.launch import mesh

    import torch_sharded_ranks

    outs = mesh.spawn(torch_sharded_ranks.cuda_sharded_rank, 2, (2, 4, 512), timeout_s=600.0)
    for out in outs:
        c = out["counts"]
        assert c["flash_attention"] == c["flash_attention_wgmma"] == 2
        assert c["expert_gate_up"] == c["expert_gate_up_wgmma"] == 2
        assert c["grouped_matmul"] == c["grouped_matmul_wgmma"] == 2
        assert out["shapes"]["flash_attention"][2] == 8
        assert out["shapes"]["grouped_expert_ffn"][0] == 32
        assert out["after_grad"] == c and out["finite_logits"]
        assert all(fin and peak > 0 for peak, fin in out["grads"].values()), out["grads"]
    assert outs[0]["loss"] == outs[1]["loss"]
