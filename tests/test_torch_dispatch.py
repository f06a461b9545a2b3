"""Which design of the redesigned kernels K2 (grouped matmul) and K4 (flash
attention) a CUDA call takes, decided on the CPU from dtype and shape alone,
and the build cache's key over the shared headers.  Nothing here needs a
card: the choices are pure Python, the launches are in
tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.expert_gemm import (  # noqa: E402
    WGMMA_MAX_E,
    grouped_matmul_design,
    grouped_matmul_prev,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    SUPPORTED_G,
    SUPPORTED_HD,
    flash_attention_design,
    flash_attention_prev,
)

MOE_ARCHS = [a for a in list_archs() if get_config(a).has_moe]
# full-size attention configs K4 serves (G and hd it is built for)
ATTN_ARCHS = [a for a in list_archs()
              if get_config(a).has_attention
              and get_config(a).num_heads // get_config(a).num_kv_heads in SUPPORTED_G
              and get_config(a).head_dim in SUPPORTED_HD]


def test_every_moe_and_attention_arch_is_covered():
    assert {"olmoe-1b-7b", "mixtral-8x7b", "jamba-1.5-large-398b",
            "phi3.5-moe-42b-a6.6b"} <= set(MOE_ARCHS)
    assert {"olmoe-1b-7b", "mixtral-8x7b", "musicgen-medium"} <= set(ATTN_ARCHS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_served_moe_shapes_take_the_wgmma_k2(arch):
    """The FFN's down projection h (E, C, F) @ wd (E, F, D) at full width,
    bf16, at decode and prefill capacities: the wgmma design; in f32 the
    SIMT one (exact to f32)."""
    cfg = get_config(arch)
    E, F, D = cfg.num_experts, cfg.moe_d_ff, cfg.d_model
    assert grouped_matmul_design(torch.bfloat16, E, F, D) == "wgmma"
    assert grouped_matmul_design(torch.float32, E, F, D) == "simt"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_moe_shapes_take_the_wgmma_k2(arch):
    cfg = get_config(arch, smoke=True)
    assert grouped_matmul_design(torch.bfloat16, cfg.num_experts, cfg.moe_d_ff,
                                 cfg.d_model) == "wgmma"


@pytest.mark.parametrize("K,N,design", [
    (1024, 2048, "wgmma"),       # OLMoE
    (14336, 4096, "wgmma"),      # Mixtral
    (8, 8, "wgmma"),             # 16-byte rows: the smallest TMA can address
    (72, 136, "wgmma"),          # multiples of 8, not of the 64 x 256 tile
    (60, 100, "wmma"),           # tests/test_torch_cuda.py's (2, 70, 100, 60)
    (1024, 2044, "wmma"),        # N % 8 != 0
    (1020, 2048, "wmma"),        # K % 8 != 0
])
def test_k2_design_by_row_alignment(K, N, design):
    assert grouped_matmul_design(torch.bfloat16, 64, K, N) == design


def test_k2_design_by_expert_count_and_dtype():
    assert grouped_matmul_design(torch.bfloat16, WGMMA_MAX_E, 1024, 2048) == "wgmma"
    assert grouped_matmul_design(torch.bfloat16, WGMMA_MAX_E + 1, 1024, 2048) == "wmma"
    assert grouped_matmul_design(torch.float32, 64, 60, 100) == "simt"


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_served_attention_shapes_take_the_wgmma_k4(arch):
    """Every full-size config K4 serves has hd 64 or 128: bf16 takes the
    wgmma design, f32 the SIMT one."""
    cfg = get_config(arch)
    assert cfg.head_dim in (64, 128)
    assert flash_attention_design(torch.bfloat16, cfg.head_dim) == "wgmma"
    assert flash_attention_design(torch.float32, cfg.head_dim) == "simt"


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_smoke_attention_shapes_keep_the_mma_k4(arch):
    """The smoke configs' hd 32 stays on the first, mma.sync kernel."""
    cfg = get_config(arch, smoke=True)
    assert cfg.head_dim == 32
    assert flash_attention_design(torch.bfloat16, cfg.head_dim) == "mma"


@pytest.mark.parametrize("hd,dtype,design", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (32, torch.bfloat16, "mma"), (64, torch.float32, "simt"),
    (128, torch.float32, "simt"), (32, torch.float32, "simt"),
])
def test_k4_design_by_head_width_and_dtype(hd, dtype, design):
    assert flash_attention_design(dtype, hd) == design


def test_launch_counts_name_both_designs():
    """``grouped_matmul`` and ``flash_attention`` count every launch of K2
    and K4; the ``_wgmma`` names count the new designs, the ``_prev`` names
    the yardstick launches of the first designs."""
    build.reset_launch_counts()
    counts = build.launch_counts()
    for name in ("grouped_matmul", "grouped_matmul_wgmma", "grouped_matmul_prev",
                 "flash_attention", "flash_attention_wgmma", "flash_attention_prev"):
        assert counts[name] == 0


def test_prev_designs_refuse_cpu_tensors():
    """The first designs' yardsticks launch on a card or raise; they have no
    plain version (the served wrappers do)."""
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_prev(x, w)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_prev(q, q, q)


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A changed ``csrc/*.cuh`` changes every library's cache key, so a
    cached library is never loaded against a header it was not built from."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._digest("k")
    assert build._digest("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = build._digest("k")
    assert edited != before
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build._digest("k") not in (before, edited)


def test_sources_include_the_shared_header():
    for name in ("expert_gemm", "flash_attention"):
        assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()
