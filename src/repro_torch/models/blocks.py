"""Layer blocks: (attention | SSM) + (dense FFN | MoE) with pre-norm residuals."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, rms_norm


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def init_ffn_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    return {
        "w_gate": dense_init((d, f), gen, dtype=dt),
        "w_up": dense_init((d, f), gen, dtype=dt),
        "w_down": dense_init((f, d), gen, dtype=dt),
    }


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


def ffn_apply_mesh(cfg: ModelConfig, p, x: torch.Tensor, ctx) -> torch.Tensor:
    """``ffn_apply`` on a mesh (``x`` the residual's layout): column-parallel
    gate and up, row-parallel down, the partial sums all-reduced
    (reduce-scattered under ``seq_shard``); when the model axis does not
    divide d_ff, each rank runs its own rows with the whole weights."""
    from repro_torch.distributed import collectives as C

    if cfg.d_ff % ctx.model_size == 0:
        return C.leave(ctx, ffn_apply(p, C.enter(ctx, x)))
    return ffn_apply({n: C.rows_weight(ctx, w) for n, w in p.items()}, x)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------
def init_layer_params(cfg: ModelConfig, kind: str, ffn_kind: str,
                      gen: torch.Generator) -> Dict:
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    p: Dict = {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    if kind == "attn":
        p["attn"] = attn_mod.init_attn_params(cfg, gen)
    else:
        p["ssm"] = ssm_mod.init_ssm_params(cfg, gen)
    if ffn_kind == "moe":
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        p["moe"] = moe_mod.init_moe_params(cfg, gen)
    elif cfg.d_ff > 0:
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        p["ffn"] = init_ffn_params(cfg, gen)
    return p


def ffn_stage(cfg: ModelConfig, ffn_kind: str, p: Dict,
              x: torch.Tensor, ctx=None,
              differentiable: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN half of a layer with its residual: norm2 -> (MoE | dense),
    the MoE as the exact dense-combine reference (the engine runs its own
    grouped dispatch).  On a mesh (``ctx``): ``moe.moe_apply`` and
    ``ffn_apply_mesh``, ``differentiable`` choosing the MoE's FFN (plain
    products, or K1 + K2)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = ctx is not None and ctx.on_mesh
    if ffn_kind == "moe":
        h = _norm(cfg, ctx, x, p["norm2"])
        if mesh:
            y, aux = moe_mod.moe_apply(cfg, p["moe"], h, ctx, differentiable)
        else:
            y, aux = moe_mod.moe_apply_local(cfg, p["moe"], h)
        x = x + y
    elif cfg.d_ff > 0:
        h = _norm(cfg, ctx, x, p["norm2"])
        x = x + (ffn_apply_mesh(cfg, p["ffn"], h, ctx) if mesh else ffn_apply(p["ffn"], h))
    return x, aux


def _norm(cfg: ModelConfig, ctx, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``rms_norm`` of the residual; on a mesh its scale is applied to the
    residual's own rows (``collectives.rows_weight``)."""
    if ctx is not None and ctx.on_mesh:
        from repro_torch.distributed import collectives as C

        scale = C.rows_weight(ctx, scale)
    return rms_norm(x, scale, cfg.norm_eps)


def layer_forward(
    cfg: ModelConfig,
    kind: str,
    ffn_kind: str,
    p: Dict,
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    differentiable: bool = False,
    ctx=None,
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Full-sequence layer.  Returns (x, cache_entry, aux_loss); ``lengths``
    (B,) masks right-padded positions of a ragged batch; ``prefix_kv`` as
    ``attention.attn_forward``'s; ``differentiable`` as ``mixer_forward``'s
    (without a mesh the MoE is the dense-combine reference either way).
    ``ctx``: a mesh context for this pass (``ShardCtx.for_sequence``); ``x``
    is then the residual's layout."""
    y, cache = mixer_forward(cfg, kind, p, x, positions, lengths, prefix_kv,
                             differentiable, ctx)
    x, aux = ffn_stage(cfg, ffn_kind, p, x + y, ctx, differentiable)
    return x, cache, aux


def mixer_forward(cfg: ModelConfig, kind: str, p: Dict, x: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None,
                  prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  differentiable: bool = False, ctx=None,
                  ) -> Tuple[torch.Tensor, Dict]:
    """The sequence-mixer half of a layer, without its residual: norm1 ->
    attention (cache ``{"k", "v"}``; ``prefix_kv``: a cached prefix's KV in
    front of the keys, as ``attention.attn_forward``'s) or SSM (cache
    ``{"h", "conv"}``).  The mechanism is K4 or K5 (serving), or with
    ``differentiable`` the reference's plain math, which autograd
    differentiates (training)."""
    h = _norm(cfg, ctx, x, p["norm1"])
    if kind == "attn":
        return attn_mod.attn_forward(cfg, p["attn"], h, positions, lengths, prefix_kv,
                                     differentiable, ctx)
    assert prefix_kv is None, "a cached prefix needs an attention layer"
    return ssm_mod.ssm_forward(cfg, p["ssm"], h, lengths, differentiable, ctx)


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """A zeroed KV cache (attention) or SSM state (SSM) on ``device``
    (``cuda`` by default; raises without CUDA)."""
    if kind == "attn":
        return attn_mod.init_kv_cache(cfg, batch, max_seq, device=device)
    return ssm_mod.init_ssm_state(cfg, batch, device=device)


def layer_decode(
    cfg: ModelConfig,
    kind: str,
    ffn_kind: str,
    p: Dict,
    x: torch.Tensor,               # (B, 1, D)
    cache: Dict,
    pos,
    ctx=None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step of a layer; the cache (KV or SSM state) is written in
    place.  ``ctx``: a mesh context (the cache is this rank's share)."""
    h = _norm(cfg, ctx, x, p["norm1"])
    if kind == "attn":
        y, cache = attn_mod.attn_decode(cfg, p["attn"], h, cache, pos, ctx)
    else:
        y, cache = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache, ctx)
    x, _ = ffn_stage(cfg, ffn_kind, p, x + y, ctx, differentiable=False)
    return x, cache
