"""Mamba2 (SSD -- state-space duality) block [arXiv:2405.21060].

Full-sequence processing runs the chunked SSD scan (``kernels.ops.ssd_scan``:
kernel K5 on a CUDA tensor, its plain version on the CPU): quadratic
attention-like work inside chunks of ``cfg.ssm_chunk`` positions and a
linear recurrence of the f32 state across them.  Decode is the O(1)
recurrent step, plain PyTorch (the JAX package computes it outside any
Pallas kernel too).

The chunk is always ``cfg.ssm_chunk``.  The reference scan takes
``Q = min(chunk, S)`` and needs ``S % Q == 0``, so it accepts a right-padded
wave only when its longest prompt is at most one chunk or a multiple of
one.  Here the scan pads the last chunk itself: positions at or past
``S`` (and past ``lengths[b]``) are padding with ``dt = 0``, so the
recurrence neither decays nor absorbs input there.  At every ``S`` the
reference accepts, the valid outputs and the final state are what it gives,
up to the order of float sums; and a row's result does not depend on the
wave it was prefilled in, which keeps the two schedulers' tokens equal.

Training runs ``ssm_forward(..., differentiable=True)``: the reference's own
chunked scan (``ssd_scan`` over ``_chunk_math``) in plain PyTorch, which
autograd differentiates (K5 has no backward), with the reference's
``Q = min(chunk, S)`` and ``S % Q == 0``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import as_drawn, dense_init, rms_norm


def init_ssm_params(cfg: ModelConfig, gen: torch.Generator,
                    keep=as_drawn) -> Dict[str, torch.Tensor]:
    """The JAX package's shapes and scales; ``A_log``, ``D`` and
    ``dt_bias`` stay f32."""
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    w = cfg.ssm_conv_width
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    ch = di + 2 * ns
    a = torch.rand((nh,), generator=gen, dtype=torch.float32, device=dev)
    return {
        "wz": keep("wz", dense_init((d, di), gen, dtype=dt)),
        "wx": keep("wx", dense_init((d, di), gen, dtype=dt)),
        "wB": keep("wB", dense_init((d, ns), gen, dtype=dt)),
        "wC": keep("wC", dense_init((d, ns), gen, dtype=dt)),
        "wdt": keep("wdt", dense_init((d, nh), gen, dtype=dt)),
        "dt_bias": keep("dt_bias", torch.zeros((nh,), dtype=torch.float32, device=dev)),
        "A_log": keep("A_log", torch.log(1.0 + 15.0 * a)),            # uniform(1, 16)
        "D": keep("D", torch.ones((nh,), dtype=torch.float32, device=dev)),
        "conv_w": keep("conv_w", dense_init((w, ch), gen, in_dim=w, dtype=dt)),
        "conv_b": keep("conv_b", torch.zeros((ch,), dtype=dt, device=dev)),
        "norm_scale": keep("norm_scale", torch.ones((di,), dtype=dt, device=dev)),
        "out_proj": keep("out_proj", dense_init((di, d), gen, dtype=dt)),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of W shifted products (the reference's
    arithmetic; no cuDNN).  u: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0))
    out = up[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + up[:, i:i + S] * w[i]
    return out + b


def _proj_inputs(cfg: ModelConfig, p, x: torch.Tensor):
    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bc = x @ p["wB"]
    Cc = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])   # (B, S, nh) f32
    return z, xs, Bc, Cc, dt


def _chunk_math(x_c, B_c, C_c, dt_c, dA_c, H):
    """One SSD chunk, the reference's arithmetic in f32.  x_c: (Bt, Q, nh,
    hp); B_c/C_c: (Bt, Q, ns); dt_c/dA_c: (Bt, Q, nh) f32; H: (Bt, nh, ns,
    hp) f32 carried state.  Returns (Y_c f32, H_next)."""
    cum = torch.cumsum(dA_c, dim=1)                             # (Bt, Q, nh)
    Q = x_c.shape[1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # (Bt, i, j, nh)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x_c.device).tril()
    # masked BEFORE exp: above-diagonal diffs are positive and would overflow
    # into the backward pass (inf * 0)
    L = torch.exp(diff.masked_fill(~causal[None, :, :, None], -1e30))
    Cf, Bf, xf = C_c.float(), B_c.float(), x_c.float()
    CB = torch.einsum("bis,bjs->bij", Cf, Bf)
    M = CB[..., None] * L * dt_c[:, None, :, :]                 # (Bt, i, j, nh)
    y_intra = torch.einsum("bijn,bjnp->binp", M, xf)
    y_inter = torch.einsum("bis,bnsp->binp", Cf, H) * torch.exp(cum)[..., None]
    w = torch.exp(cum[:, -1:, :] - cum) * dt_c                  # (Bt, Q, nh)
    S_c = torch.einsum("bjn,bjs,bjnp->bnsp", w, Bf, xf)
    H_next = H * torch.exp(cum[:, -1])[:, :, None, None] + S_c
    return y_intra + y_inter, H_next


def ssd_scan(x: torch.Tensor, B_in: torch.Tensor, C_in: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked SSD, differentiable.  x (B, S, nh, hp), B/C
    (B, S, ns), dt (B, S, nh) f32, A (nh,) f32 -> (y (B, S, nh, hp) in x's
    dtype, final state (B, nh, ns, hp) f32)."""
    Bt, S, nh, hp = x.shape
    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by chunk {Q}"
    dA = dt * A
    H = (torch.zeros((Bt, nh, B_in.shape[-1], hp), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for lo in range(0, S, Q):
        sl = slice(lo, lo + Q)
        y, H = _chunk_math(x[:, sl], B_in[:, sl], C_in[:, sl], dt[:, sl], dA[:, sl], H)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), H


def ssm_forward(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    differentiable: bool = False,
    ctx=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block.  Returns (y, {"h", "conv"}) for prefill
    caching.

    ``lengths`` (B,) handles right-padded ragged batches: ``dt`` is zeroed
    at padded positions, so the cached state is the state at each row's
    own length, and the conv tail is gathered at each row's own last
    ``W - 1`` positions (zeros where a row is shorter than that, the
    reference's left zero padding).  ``differentiable``: the scan is
    ``ssd_scan`` (training) instead of K5.

    On a mesh (``ctx``; ``x`` the residual's layout) whose model axis
    divides the heads, each rank runs its nh/m heads (K5 on the card
    without autograd) with B and C whole (``_local_weights``), the gated
    norm's squared sum all-reduced, ``out_proj`` row-parallel; the state is
    this rank's heads and conv channels ``[xs share | B | C]``.  Otherwise
    every rank runs the whole block on the whole sequence."""
    if ctx is not None and ctx.on_mesh:
        from repro_torch.distributed import collectives as C

        if cfg.ssm_nheads % ctx.model_size:      # every rank runs the whole block
            out, state = _ssm_block(cfg, p, C.whole_sequence(ctx, x), lengths, differentiable)
            return C.residual_rows(ctx, out), state
        out, state = _ssm_block(cfg, _local_weights(cfg, p, ctx), C.enter(ctx, x), lengths,
                                differentiable, ctx)
        return C.leave(ctx, out), state
    return _ssm_block(cfg, p, x, lengths, differentiable)


def _ssm_block(cfg: ModelConfig, p, x: torch.Tensor, lengths, differentiable: bool,
               ctx=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``ssm_forward``'s block on the heads and channels ``p`` holds (all of
    them, or on a mesh, ``ctx``, this rank's: the gated norm's squared sum
    then spans the model axis)."""
    B, S, _ = x.shape
    ns, hp = cfg.ssm_state, cfg.ssm_headdim
    di, nh = p["wx"].shape[1], p["wdt"].shape[1]
    z, xs, Bc, Cc, dt = _proj_inputs(cfg, p, x)
    u = torch.cat([xs, Bc, Cc], dim=-1)
    W = cfg.ssm_conv_width - 1
    pos = torch.arange(S, device=x.device)
    lens = (torch.full((B,), S, device=x.device, dtype=torch.long) if lengths is None
            else torch.as_tensor(lengths, device=x.device).reshape(B).long())
    if lengths is not None:
        dt = dt * (pos[None, :] < lens[:, None])[..., None]
    tail_pos = lens[:, None] - W + torch.arange(W, device=x.device)[None, :]  # (B, W)
    conv_tail = torch.gather(
        u, 1, tail_pos.clamp_min(0)[..., None].expand(B, W, u.shape[-1])
    ) * (tail_pos >= 0)[..., None].to(u.dtype)
    u = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    xs, Bc, Cc = torch.split(u, [di, ns, ns], dim=-1)
    xh = xs.reshape(B, S, nh, hp)
    A = -torch.exp(p["A_log"])
    if differentiable:
        y, H = ssd_scan(xh, Bc, Cc, dt, A, cfg.ssm_chunk)
    else:
        y, H = ops.ssd_scan(xh.contiguous(), Bc.contiguous(), Cc.contiguous(),
                            dt.contiguous(), A.contiguous(), cfg.ssm_chunk,
                            lengths=lengths)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = _gated_norm(cfg, ctx, y.reshape(B, S, di), z, p["norm_scale"])
    out = y @ p["out_proj"]
    return out, {"h": H, "conv": conv_tail}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed f32 state ``h`` (batch, nh, ns, hp) and conv tail (batch,
    W - 1, d_inner + 2 ns) on ``device`` (``cuda`` by default; raises
    without CUDA)."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    di, ns, nh, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    return {
        "h": torch.zeros((batch, nh, ns, hp), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
    }


def ssm_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, 1, D)
    state: Dict[str, torch.Tensor],        # written in place
    ctx=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) decode step: the recurrent SSM update.  ``state``'s ``h`` and
    ``conv`` are written IN PLACE (views of the engine's cache rows stay
    its rows).  Returns (y (B, 1, D), state) -- the same tensors.  On a
    mesh (``ctx``) whose model axis divides the heads each rank steps its
    own heads and conv channels (its state), the gated norm's squared sum
    all-reduced and ``out_proj``'s partial sums too."""
    split = (ctx is not None and ctx.on_mesh and ctx.model_size > 1
             and cfg.ssm_nheads % ctx.model_size == 0)
    if split:
        from repro_torch.distributed import collectives as C

        p, x = _local_weights(cfg, p, ctx), C.to_model(ctx, x)
    B = x.shape[0]
    ns, hp = cfg.ssm_state, cfg.ssm_headdim
    di, nh = p["wx"].shape[1], p["wdt"].shape[1]
    z, xs, Bc, Cc, dt = _proj_inputs(cfg, p, x)                 # (B, 1, .)
    u_t = torch.cat([xs, Bc, Cc], dim=-1)                        # (B, 1, ch)
    win = torch.cat([state["conv"], u_t], dim=1)                 # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", win.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    xs, Bc, Cc = torch.split(conv_out.to(x.dtype), [di, ns, ns], dim=-1)
    xh = xs.reshape(B, nh, hp).float()
    dt1 = dt[:, 0]                                               # (B, nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * A)                                      # (B, nh)
    h = state["h"] * dA[:, :, None, None] + (
        Bc.float()[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :])
    y = torch.einsum("bs,bnsp->bnp", Cc.float(), h)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gated_norm(cfg, ctx if split else None, y, z, p["norm_scale"])
    out = y @ p["out_proj"]
    state["h"].copy_(h)
    state["conv"].copy_(win[:, 1:])
    return (C.reduce_model(ctx, out) if split else out), state


# ---------------------------------------------------------------------------
# On a mesh (the model-sharding path)
# ---------------------------------------------------------------------------
def _local_weights(cfg: ModelConfig, p, ctx):
    """This rank's SSM weights as used: ``wB``/``wC``, the B and C channels
    of ``conv_w`` and the whole ``conv_b`` and ``norm_scale`` serve every
    rank's heads, so their gradients are all-reduced over the model axis;
    ``conv_b`` is cut to ``[xs share | B | C]`` and the gated norm's scale
    to this rank's channels."""
    from repro_torch.distributed import collectives as C

    di, r = cfg.ssm_d_inner, ctx.model_rank
    di_l = di // ctx.model_size
    w = dict(p)
    for n in ("wB", "wC"):
        w[n] = C.to_model(ctx, p[n])
    cw = p["conv_w"]
    w["conv_w"] = torch.cat([cw[:, :di_l], C.to_model(ctx, cw[:, di_l:])], dim=-1)
    cb = C.to_model(ctx, p["conv_b"])
    w["conv_b"] = torch.cat([cb[r * di_l:(r + 1) * di_l], cb[di:]])
    w["norm_scale"] = C.to_model(ctx, p["norm_scale"])[r * di_l:(r + 1) * di_l]
    return w


def _gated_norm(cfg: ModelConfig, ctx, y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` over all of d_inner.  On a mesh (``ctx``)
    each rank holds a share of the channels: the squared sum is all-reduced
    over the model axis (its gradient too: every rank's channels read it)."""
    if ctx is None:
        return rms_norm(y * F.silu(z), scale, cfg.norm_eps)
    from repro_torch.distributed import collectives as C

    yz = y * F.silu(z)
    xf = yz.float()
    ss = C.to_model(ctx, C.reduce_model(ctx, xf.square().sum(dim=-1, keepdim=True)))
    out = xf * torch.rsqrt(ss / cfg.ssm_d_inner + cfg.norm_eps)
    return (out * scale.float()).to(yz.dtype)
