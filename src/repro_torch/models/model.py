"""Decoder-only model: attention, SSM (Mamba2) and hybrid layer stacks, each
layer followed by an MoE, a dense FFN or nothing.

Parameters are a dict of tensors with the layers as a per-layer list
(``params["layers"][i]``), not stacked over layer groups: PyTorch runs
eagerly, so there is no trace to keep one-group-sized.

``forward`` and ``loss_fn`` are the training path: the reference's plain
math (``differentiable=True``: no kernel, which would have no backward),
with remat by ``torch.utils.checkpoint`` over each layer group of
``layer_pattern`` (the reference's scan body) and a chunked vocabulary
loss.  ``prefill`` and ``decode_step`` are the serving path (the kernels).

Each takes a ``ctx`` (``sharding.specs.ShardCtx``): on a mesh of rank
processes, ``params`` are this rank's tensors (``specs.shard_params``),
``tokens`` (and ``labels``, ``lengths``) this rank's rows of the batch
(``rows_of``), and the caches this rank's share.  The embedding is split on
D and all-gathered, the LM head on the vocabulary (the loss is a
vocabulary-parallel log-sum-exp, so no rank holds the (B, S, V) logits);
``forward``'s logits come back whole (all-gathered over the vocabulary) for
this rank's rows.  Every rank of a model axis gets the same result.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.blocks import (
    init_layer_cache,
    init_layer_params,
    layer_decode,
    layer_forward,
)
from repro_torch.models.layers import dense_init, rms_norm


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, str]]:
    g = cfg.attn_period if cfg.attn_period else 1
    if cfg.has_moe:
        g = math.lcm(g, cfg.moe_layer_period)
    assert cfg.num_layers % g == 0, (cfg.name, cfg.num_layers, g)
    pattern = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(g)]
    for i in range(cfg.num_layers):
        assert (cfg.layer_kind(i), cfg.ffn_kind(i)) == pattern[i % g]
    return pattern


def layer_schema(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer kind, FFN kind) of every layer."""
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Seeded weights drawn on ``device`` with a ``torch.Generator``: the
    JAX package's shapes, dtypes and ``dense_init`` scales, not its bits."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    layers = [init_layer_params(cfg, kind, ffn, gen)
              for kind, ffn in layer_schema(cfg)]
    return {"layers": layers, **init_base_params(cfg, gen)}


def init_base_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """The base weights (embedding, final norm, LM head), drawn from
    ``gen`` after every layer, as ``init_params`` draws them."""
    dt = torch_dtype(cfg.dtype)
    base = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), gen, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        base["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), gen, dtype=dt)
    return base


def head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head."""
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
           frontend_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings; ``frontend_emb`` (B, F, D) replaces the first F
    positions (a modality frontend's frames or patches)."""
    x = params["embed"][tokens]
    if frontend_emb is not None:
        F = frontend_emb.shape[1]
        x = torch.cat([frontend_emb.to(x.dtype), x[:, F:]], dim=1)
    return x


# ---------------------------------------------------------------------------
# Full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: keep the outputs of products without batch
    dimensions (``mm``/``addmm``, what ``x @ W`` becomes), recompute the
    rest -- ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat_policy: str):
    """``fn`` under non-reentrant activation checkpointing: its inputs are
    kept and its body recomputed in the backward pass (``"full"``), or the
    products ``_dots_policy`` names are kept too (``"dots"``)."""
    kw = {"use_reentrant": False}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    elif remat_policy != "full":
        raise ValueError(f"remat_policy {remat_policy!r}: 'full' or 'dots'")
    return functools.partial(checkpoint, fn, **kw)


def forward(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,                  # (B, S) int
    frontend_emb: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits_mode: str = "full",             # full | last | none
    remat_policy: str = "full",            # full | dots
    lengths: Optional[torch.Tensor] = None,
    differentiable: bool = True,
    ctx=None,
):
    """Returns (logits (B, S, V), (B, 1, V) or the final hidden state, aux
    loss (f32), caches).

    ``lengths`` (B,) masks the padded positions of a right-padded batch,
    and ``logits_mode="last"`` then takes each row's own last token.
    ``remat`` checkpoints each layer group of ``layer_pattern`` (the
    reference's scan body) under ``remat_policy``.  ``differentiable``
    (the default) runs the reference's plain attention and SSM math, which
    autograd differentiates; False runs the serving kernels (``prefill``).
    On a mesh (``ctx``) the final hidden state (``"none"``) is in the
    residual's layout: this rank's share of the sequence under
    ``seq_shard``."""
    pattern = layer_pattern(cfg)
    B, S = tokens.shape
    mesh = ctx is not None and ctx.on_mesh
    if mesh:
        ctx = ctx.for_sequence(S)
        x = _embed_mesh(cfg, params, tokens, frontend_emb, ctx)
    else:
        ctx = None
        x = _embed(cfg, params, tokens, frontend_emb)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, aux, *group):
        caches = []
        for (kind, ffn), p in zip(pattern, group):
            x, cache, a = layer_forward(cfg, kind, ffn, p, x, positions, lengths,
                                        differentiable=differentiable, ctx=ctx)
            caches.append(cache)
            aux = aux + a
        return x, aux, caches

    step = _remat(body, remat_policy) if remat else body
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Dict] = []
    g = len(pattern)
    for lo in range(0, cfg.num_layers, g):
        x, aux, group_caches = step(x, aux, *params["layers"][lo:lo + g])
        caches.extend(group_caches)
    if logits_mode == "none":
        return x, aux, caches
    if mesh:
        return _logits_mesh(cfg, params, x, ctx, logits_mode == "last", lengths), aux, caches
    if logits_mode == "last":
        if lengths is not None:
            lens = torch.as_tensor(lengths, device=x.device).long()
            last = x[torch.arange(B, device=x.device), lens - 1][:, None]
        else:
            last = x[:, -1:]
        return head(cfg, params, last), aux, caches
    return head(cfg, params, x), aux, caches


def loss_fn(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    frontend_emb: Optional[torch.Tensor] = None,
    remat: bool = True,
    aux_weight: float = 0.01,
    vocab_chunk: int = 1024,
    remat_policy: str = "full",
    ctx=None,
):
    """Mean-token NLL with a chunked vocabulary projection: the final hidden
    states are projected and reduced to per-token NLL a sequence chunk at a
    time (each chunk checkpointed under ``remat``), so the (B, S, V) logits
    are never all held.  Returns (total, (nll, aux)).  On a mesh (``ctx``)
    the NLL is over every rank's rows (``loss_fn_mesh``)."""
    if ctx is not None and ctx.on_mesh:
        return loss_fn_mesh(cfg, params, tokens, labels, frontend_emb, ctx, remat,
                            aux_weight, vocab_chunk, remat_policy)
    x, aux, _ = forward(cfg, params, tokens, frontend_emb, remat=remat,
                        logits_mode="none", remat_policy=remat_policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    B, S, _ = x.shape
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    n_chunks = max(1, S // vocab_chunk) if S % vocab_chunk == 0 else 1
    c = S // n_chunks

    def chunk_nll(xs, ls, w):
        lg = (xs @ w).float()
        lse = torch.logsumexp(lg, dim=-1)
        lab = torch.gather(lg, -1, ls[..., None].long())[..., 0]
        return (lse - lab).sum()

    nll_of = functools.partial(checkpoint, chunk_nll, use_reentrant=False) if remat \
        else chunk_nll
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, c):
        total = total + nll_of(x[:, lo:lo + c], labels[:, lo:lo + c], w)
    nll = total / (B * S)
    return nll + aux_weight * aux, (nll, aux)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def prefill(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,                  # (B, S) int
    frontend_emb: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    ctx=None,
):
    """Returns (last-token logits (B, 1, V), caches): ``forward`` on the
    serving kernels (on a mesh, ``ctx``: this rank's rows and cache share).

    Cache entries are the raw per-layer ``{"k", "v"}`` of shape (B, S, K, hd)
    with rope applied (``serving.kvcache`` aligns them into decode buffers),
    or an SSM layer's ``{"h", "conv"}`` state at each row's length.
    ``lengths`` (B,) makes a ragged right-padded batch exact;
    ``frontend_emb`` replaces the first positions' embeddings.  The MoE runs
    the dense-combine reference."""
    logits, _, caches = forward(cfg, params, tokens, frontend_emb, logits_mode="last",
                                lengths=lengths, differentiable=False, ctx=ctx)
    return logits, caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               ctx=None) -> List:
    """Zeroed decode caches of every layer (KV buffers or SSM states) on
    ``device`` (``cuda`` by default, like ``init_params``; raises without
    CUDA).  On a mesh (``ctx``): this rank's share (``specs.shard_cache``)."""
    dev = resolve_device(device)
    cache = [init_layer_cache(cfg, kind, batch, max_seq, dev)
             for kind, _ in layer_schema(cfg)]
    if ctx is not None and ctx.on_mesh:
        from repro_torch.sharding.specs import shard_cache

        cache = shard_cache(ctx, cfg, cache)
    return cache


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    cache: List,
    tokens: torch.Tensor,              # (B,) int
    pos,                               # int or (B,) int current position
    ctx=None,
):
    """One token for every sequence.  Returns (logits (B, V), cache); the
    cache tensors are written in place.  On a mesh (``ctx``): this rank's
    rows and cache share, the logits whole."""
    if ctx is not None and ctx.on_mesh:
        ctx = ctx.for_sequence(1)
        x = _embed_mesh(cfg, params, tokens[:, None], None, ctx)
        for (kind, ffn), p, c in zip(layer_schema(cfg), params["layers"], cache):
            x, _ = layer_decode(cfg, kind, ffn, p, x, c, pos, ctx)
        return _logits_mesh(cfg, params, x, ctx, False, None)[:, 0], cache
    x = params["embed"][tokens][:, None]
    for (kind, ffn), p, c in zip(layer_schema(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, kind, ffn, p, x, c, pos)
    return head(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# On a mesh (the model-sharding path)
# ---------------------------------------------------------------------------
def rows_of(ctx, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows (dim 0) of a whole batch ``t``: the batch splits
    over the batch axes (every rank of a model axis gets the same rows).
    Without a mesh, ``t``."""
    if ctx is None or ctx.batch_size <= 1:
        return t
    n = t.shape[0] // ctx.batch_size
    if n * ctx.batch_size != t.shape[0]:
        raise ValueError(f"a batch of {t.shape[0]} rows does not split over "
                         f"{ctx.batch_size} data ranks")
    return t[ctx.batch_rank * n:(ctx.batch_rank + 1) * n]


def _embed_mesh(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                frontend_emb: Optional[torch.Tensor], ctx) -> torch.Tensor:
    """``_embed`` on a mesh: the rows of this rank's share of D, all-gathered
    (every rank uses the whole embedding), then the residual's layout."""
    from repro_torch.distributed import collectives as C
    from repro_torch.sharding.specs import placement

    x = params["embed"][tokens]
    if placement(cfg, ctx.model_size, "embed") is not None:
        x = C.gather_model(ctx, x, 2, partial=False)
    if frontend_emb is not None:
        F = frontend_emb.shape[1]
        x = torch.cat([frontend_emb.to(x.dtype), x[:, F:]], dim=1)
    return C.residual_rows(ctx, x)


def _head_weight(cfg: ModelConfig, params: Dict, ctx):
    """The LM head as this rank uses it: ``(w (D, V/m), True)`` when it
    splits over the vocabulary (the tied embedding's D shares gathered
    first), else ``(w (D, V), False)``, every rank using it whole."""
    from repro_torch.distributed import collectives as C
    from repro_torch.sharding.specs import placement

    m, r = ctx.model_size, ctx.model_rank
    V = cfg.vocab_size
    if not cfg.tie_embeddings:
        return params["lm_head"], placement(cfg, m, "lm_head") is not None
    e = params["embed"]
    d_split = placement(cfg, m, "embed") is not None
    if V % m or m == 1:
        return (C.gather_model(ctx, e, 1, partial=False) if d_split else e).T, False
    e = C.gather_model(ctx, e, 1, partial=True) if d_split else C.to_model(ctx, e)
    return e[r * (V // m):(r + 1) * (V // m)].T, True


def _logits_mesh(cfg: ModelConfig, params: Dict, x: torch.Tensor, ctx, last: bool,
                 lengths) -> torch.Tensor:
    """``head`` on a mesh (``x`` the residual's layout): the vocabulary
    shares all-gathered, for every position or (``last``) each row's last
    one."""
    from repro_torch.distributed import collectives as C

    xn = rms_norm(x, C.rows_weight(ctx, params["final_norm"]), cfg.norm_eps)
    w, v_split = _head_weight(cfg, params, ctx)
    h = C.enter(ctx, xn) if v_split else C.whole_sequence(ctx, xn)
    if last:
        if lengths is not None:
            lens = torch.as_tensor(lengths, device=h.device).long()
            h = h[torch.arange(h.shape[0], device=h.device), lens - 1][:, None]
        else:
            h = h[:, -1:]
    logits = h @ w
    return C.gather_model(ctx, logits, 2, partial=False) if v_split else logits


def loss_fn_mesh(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
                 frontend_emb, ctx, remat: bool = True, aux_weight: float = 0.01,
                 vocab_chunk: int = 1024, remat_policy: str = "full"):
    """``loss_fn`` on a mesh.  The LM head splits over the vocabulary: each
    rank projects a chunk onto its V/m columns and the per-token
    log-sum-exp and label logit come from the shares (a max and two sums
    all-reduced over the model axis), so no rank holds the (B, S, V) logits.
    The NLL sums over this rank's rows, all-reduced over the batch axes and
    divided by the global token count; ``aux`` as the MoE layers give it."""
    from repro_torch.distributed import collectives as C

    B, S = tokens.shape
    x, aux, _ = forward(cfg, params, tokens, frontend_emb, remat=remat, logits_mode="none",
                        remat_policy=remat_policy, ctx=ctx)
    ctx = ctx.for_sequence(S)
    xn = rms_norm(x, C.rows_weight(ctx, params["final_norm"]), cfg.norm_eps)
    w, v_split = _head_weight(cfg, params, ctx)
    h = C.enter(ctx, xn) if v_split else C.whole_sequence(ctx, xn)
    n_chunks = max(1, S // vocab_chunk) if S % vocab_chunk == 0 else 1
    c = S // n_chunks
    v_lo, v_n = ctx.model_rank * w.shape[1], w.shape[1]

    def chunk_nll(xs, ls, w):
        lg = (xs @ w).float()
        if not v_split:
            lse = torch.logsumexp(lg, dim=-1)
            return (lse - torch.gather(lg, -1, ls[..., None].long())[..., 0]).sum()
        mx = C.max_model(ctx, lg.amax(dim=-1))
        lse = torch.log(C.reduce_model(ctx, torch.exp(lg - mx[..., None]).sum(dim=-1))) + mx
        loc = ls.long() - v_lo
        mine = (loc >= 0) & (loc < v_n)
        pick = torch.gather(lg, -1, loc.clamp(0, v_n - 1)[..., None])[..., 0]
        lab = C.reduce_model(ctx, torch.where(mine, pick, torch.zeros_like(pick)))
        return (lse - lab).sum()

    nll_of = functools.partial(checkpoint, chunk_nll, use_reentrant=False) if remat \
        else chunk_nll
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S, c):
        total = total + nll_of(h[:, lo:lo + c], labels[:, lo:lo + c], w)
    nll = C.reduce_batch(ctx, total) / (B * ctx.batch_size * S)
    return nll + aux_weight * aux, (nll, aux)
