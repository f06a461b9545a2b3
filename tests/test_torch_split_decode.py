"""The redesigned K3 (split-KV decode attention) and K1 (gate/up on K2's
wgmma core), decided and mirrored on the CPU: which design a CUDA call of
each config's shapes takes, the split partition, and a plain mirror of the
split-and-merge arithmetic (``kernels.ref.decode_attention_split_ref``)
against the plain version and the JAX oracle.  The kernels themselves are
held to their plain versions in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_SLOTS,
    SUPPORTED_G,
    SUPPORTED_HD,
    decode_attention_design,
    decode_attention_prev,
    split_partition,
)
from repro_torch.kernels.expert_gemm import (  # noqa: E402
    WGMMA_MAX_E,
    expert_gate_up_design,
    expert_gate_up_prev,
)

RNG = np.random.default_rng(15)
TOL = 2e-5                   # f32 on both sides: summation order only
CONFIGS = [(a, smoke) for a in list_archs() for smoke in (False, True)]


def _k3_served(cfg) -> bool:
    return (cfg.has_attention and cfg.num_heads // cfg.num_kv_heads in SUPPORTED_G
            and cfg.head_dim in SUPPORTED_HD)


# every full-size and smoke config with a decode attention K3 is built for,
# and every one with MoE layers
K3_CONFIGS = [c for c in CONFIGS if _k3_served(get_config(c[0], smoke=c[1]))]
MOE_CONFIGS = [c for c in CONFIGS if get_config(c[0], smoke=c[1]).has_moe]


def test_config_lists_cover_the_served_models():
    for arch in ("olmoe-1b-7b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        assert (arch, False) in K3_CONFIGS and (arch, True) in K3_CONFIGS
        assert (arch, False) in MOE_CONFIGS and (arch, True) in MOE_CONFIGS


@pytest.mark.parametrize("arch,smoke", K3_CONFIGS)
def test_k3_design_on_every_config(arch, smoke):
    """Full-size configs K3 serves (hd 64 or 128) take the split design in
    bf16; hd 32 (every smoke config) and f32 keep the first, SIMT one."""
    cfg = get_config(arch, smoke=smoke)
    G, hd = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    assert decode_attention_design(torch.bfloat16, G, hd) == (
        "simt" if smoke else "split")
    assert decode_attention_design(torch.float32, G, hd) == "simt"


@pytest.mark.parametrize("arch,smoke", MOE_CONFIGS)
def test_k1_design_on_every_config(arch, smoke):
    """Every MoE config's gate/up shapes, full-size and smoke, have 16-byte
    rows: bf16 takes the wgmma design at decode and prefill capacities, f32
    the SIMT one."""
    cfg = get_config(arch, smoke=smoke)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for C in (1, 8, 64, 65, 2048, 32768):
        assert expert_gate_up_design(torch.bfloat16, E, D, F, C) == "wgmma"
        assert expert_gate_up_design(torch.float32, E, D, F, C) == "simt"


def test_served_configs_take_the_new_designs():
    for arch in ("olmoe-1b-7b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        assert decode_attention_design(
            torch.bfloat16, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim) == "split"
        assert expert_gate_up_design(torch.bfloat16, cfg.num_experts, cfg.d_model,
                                     cfg.moe_d_ff, 64) == "wgmma"


@pytest.mark.parametrize("D,F,E,design", [
    (2048, 1024, 64, "wgmma"),          # OLMoE
    (4096, 14336, 8, "wgmma"),          # Mixtral
    (72, 136, 2, "wgmma"),              # multiples of 8, not of the tiles
    (100, 60, 2, "wmma"),               # rows of 200 and 120 bytes
    (2048, 1020, 64, "wmma"),           # F % 8 != 0
    (2044, 1024, 64, "wmma"),           # D % 8 != 0
    (2048, 1024, WGMMA_MAX_E + 1, "wmma"),
])
def test_k1_design_by_row_alignment(D, F, E, design):
    assert expert_gate_up_design(torch.bfloat16, E, D, F, 64) == design


@pytest.mark.parametrize("hd,dtype,design", [
    (64, torch.bfloat16, "split"), (128, torch.bfloat16, "split"),
    (32, torch.bfloat16, "simt"), (64, torch.float32, "simt"),
    (128, torch.float32, "simt"),
])
def test_k3_design_by_head_width_and_dtype(hd, dtype, design):
    for G in SUPPORTED_G:
        assert decode_attention_design(dtype, G, hd) == design


@pytest.mark.parametrize("S", [1, 63, 64, 255, 256, 257, 288, 600, 3648, 4096])
def test_split_partition_covers_every_slot_once(S):
    """Splits of SPLIT_SLOTS slots, cut by slot index alone: slot s is in
    split s // SPLIT_SLOTS, every slot of 0..S-1 exactly once."""
    parts = split_partition(S)
    assert len(parts) == -(-S // SPLIT_SLOTS)
    slots = [s for lo, hi in parts for s in range(lo, hi)]
    assert slots == list(range(S))
    for i, (lo, hi) in enumerate(parts):
        assert lo == i * SPLIT_SLOTS and 0 < hi - lo <= SPLIT_SLOTS
    assert SPLIT_SLOTS % 32 == 0          # whole 32-slot tiles of the kernel


def _rand(shape):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


def test_split_partition_depends_on_S_alone():
    """A row's splits and partials are the same alone (B = 1) and inside a
    batch of 64: nothing of the partition depends on B or on other rows."""
    H, K, hd, S = 4, 2, 32, 600
    q, k, v = _rand((64, H, hd)), _rand((64, S, K, hd)), _rand((64, S, K, hd))
    pos = torch.from_numpy(RNG.integers(-1, S + 10, 64))
    pos[0] = 300
    _, (m1, l1, a1) = ref.decode_attention_split_ref(q[:1], k[:1], v[:1], pos[:1],
                                                     SPLIT_SLOTS, partials=True)
    _, (m64, l64, a64) = ref.decode_attention_split_ref(q, k, v, pos, SPLIT_SLOTS,
                                                        partials=True)
    assert m1.shape[-1] == m64.shape[-1] == len(split_partition(S))
    assert torch.equal(torch.isinf(m1[0]), torch.isinf(m64[0]))
    assert (l1[0] == 0).tolist() == (l64[0] == 0).tolist()
    torch.testing.assert_close(a1[0], a64[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(l1[0], l64[0], atol=1e-6, rtol=0)


# (S, G, hd, pos): splits wholly past pos, pos at a split edge (L - 1, L),
# S not a multiple of L, pos past S (a sliding-window ring: every slot
# valid), one slot, pos < 0
SPLIT_CASES = [
    (600, 1, 64, [10, 255, 256, 599]),
    (600, 4, 32, [0, 257, 511, 512]),
    (257, 2, 64, [256, 255, 1000, 3]),
    (256, 8, 32, [255, 0, 128, 200]),
    (1, 1, 64, [0, 0, 5, 0]),
    (300, 2, 32, [-1, 299, 17, -5]),
]


@pytest.mark.parametrize("S,G,hd,pos", SPLIT_CASES)
def test_split_mirror_matches_plain(S, G, hd, pos):
    """The split-and-merge arithmetic against the plain version, f32 within
    2e-5; a row with pos < 0 is zeros (the plain version spreads it evenly
    over every slot instead: the documented difference)."""
    B, K = len(pos), 2
    q, k, v = _rand((B, K * G, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    posv = torch.tensor(pos)
    got = ref.decode_attention_split_ref(q, k, v, posv, SPLIT_SLOTS)
    want = ref.decode_attention_ref(q, k, v, posv)
    for b, p in enumerate(pos):
        if p < 0:
            assert torch.count_nonzero(got[b]) == 0
        else:
            assert (got[b] - want[b]).abs().max() < TOL


@pytest.mark.parametrize("S,G,hd,pos", [c for c in SPLIT_CASES if min(c[3]) >= 0])
def test_split_mirror_matches_jax_per_row(S, G, hd, pos):
    """Per row, one scalar-pos call of the JAX oracle."""
    B, K = len(pos), 2
    q, k, v = _rand((B, K * G, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    got = ref.decode_attention_split_ref(q, k, v, torch.tensor(pos), SPLIT_SLOTS)
    for b, p in enumerate(pos):
        want = np.asarray(jref.decode_attention_ref(
            jnp.asarray(q[b:b + 1].numpy()), jnp.asarray(k[b:b + 1].numpy()),
            jnp.asarray(v[b:b + 1].numpy()), min(p, S - 1)))
        assert np.abs(got[b:b + 1].numpy() - want).max() < TOL


def test_split_mirror_ignores_poisoned_slots():
    """Keys set to 1e4 and values to NaN past pos change nothing: those
    slots count as zero rows with masked scores."""
    B, H, K, hd, S = 3, 4, 2, 64, 600
    q, k, v = _rand((B, H, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    pos = torch.tensor([100, 256, 511])
    base = ref.decode_attention_split_ref(q, k, v, pos, SPLIT_SLOTS)
    k2, v2 = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        k2[b, p + 1:] = 1e4
        v2[b, p + 1:] = float("nan")
    assert torch.equal(ref.decode_attention_split_ref(q, k2, v2, pos, SPLIT_SLOTS), base)


def test_prev_wrappers_refuse_cpu_tensors():
    """The first designs' yardsticks launch on a card or raise; they have no
    plain version (the served wrappers do)."""
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_prev(q, kv, kv, 3)
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        expert_gate_up_prev(x, w, w)


def test_launch_counts_name_the_new_designs():
    build.reset_launch_counts()
    counts = build.launch_counts()
    for name in ("expert_gate_up", "expert_gate_up_wgmma", "expert_gate_up_prev",
                 "decode_attention", "decode_attention_split", "decode_attention_prev"):
        assert counts[name] == 0
    assert {"repro_expert_gate_up_wgmma", "repro_decode_attention_split"} <= set(
        build._ARGTYPES)
