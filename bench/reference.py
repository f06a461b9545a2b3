"""The plain reference: the configuration's forward pass in float32.

Plain PyTorch operations (TF32 off), with no kernel, cache or batching of
the program's: pre-norm decoder layers of RMS norm, grouped-query attention
with half-split rotary embeddings over the whole causal span, and a sparse
MoE whose router takes a softmax over every expert, keeps the top k and
renormalises their gates.  It draws its weights again from the seed, layer
by layer (``weights.py``), so it holds one layer at a time, and takes
nothing the program made.

``judge`` runs it over each sampled request's prompt and served tokens and
gives, for each served token, how far its logit lies below the reference's
best at that position.  ``lower`` runs beside it the same pass with every
matrix product's operands rounded to a lower precision: ``"float8"`` (e4m3,
one scale per row of activations and per output column of weights), the
precision below the configurations' bfloat16 and so the control; and
``"bfloat16"``, the configurations' own, a witness of how far that
precision alone moves the tokens.  Their reading is, at each position, the
gap of the token each puts first.

Imports neither the program nor JAX.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench import weights as W
from bench.spec import Sizes

F8_MAX = 448.0


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the scale maps the slice's largest magnitude to e4m3's 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def bf16(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to bfloat16 (``dim`` unused: no scale)."""
    return t.to(torch.bfloat16).to(torch.float32)


CONTROL, WITNESS = "float8", "bfloat16"
LOWER = {CONTROL: q8, WITNESS: bf16}


class _Path:
    """One precision's matrix products: float32 (``low`` None), or with each
    operand rounded by ``LOWER[low]`` first."""

    def __init__(self, low: Optional[str] = None) -> None:
        self.round = LOWER[low] if low else None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.round(x, -1) if self.round else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self.round(w, -2) if self.round else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(w)


def attention(sz: Sizes, path: _Path, p: Dict, h: torch.Tensor,
              q_block: int = 1024) -> torch.Tensor:
    """Causal GQA over one sequence h (S, D); query head i reads KV head
    i // (H / K); scores scaled by hd ** -0.5."""
    S = h.shape[0]
    H, K, hd = sz.n_heads, sz.n_kv_heads, sz.head_dim
    G = H // K
    q = rope(path.mm(h, p["wq"]).view(S, H, hd), sz.rope_theta).view(S, K, G, hd)
    k = rope(path.mm(h, p["wk"]).view(S, K, hd), sz.rope_theta)
    v = path.mm(h, p["wv"]).view(S, K, hd)
    out = torch.empty((S, K, G, hd), dtype=torch.float32, device=h.device)
    kpos = torch.arange(S, device=h.device)
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        s = torch.einsum("skgd,tkd->kgst", q[lo:hi], k[:hi]) * hd ** -0.5
        mask = kpos[None, :hi] <= torch.arange(lo, hi, device=h.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out[lo:hi] = torch.einsum("kgst,tkd->skgd", torch.softmax(s, dim=-1), v[:hi])
    return path.mm(out.reshape(S, H * hd), p["wo"])


def moe(sz: Sizes, path: _Path, p: Dict, h: torch.Tensor) -> torch.Tensor:
    """Top-k of a softmax over every expert, gates renormalised over the k;
    each expert's SwiGLU FFN on the rows routed to it."""
    probs = torch.softmax(h @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, sz.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(sz.n_experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = path.mm(x, p["experts_w_gate"][e])
        u = path.mm(x, p["experts_w_up"][e])
        o = path.mm(torch.nn.functional.silu(g) * u, p["experts_w_down"][e])
        y.index_add_(0, rows, o * gates[rows, slot][:, None])
    return y


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@contextlib.contextmanager
def _exact():
    """Float32 products in float32: TF32 off for the pass."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@torch.no_grad()
def logits(sz: Sizes, seed: int, seqs: Sequence[np.ndarray], want: Sequence[np.ndarray],
           device, lower: Sequence[str] = ()) -> List[List[torch.Tensor]]:
    """For each path (the reference, then each of ``lower``) and each
    sequence, the float32 logits (len(want[i]), V) at positions ``want[i]``
    of the causal pass over ``seqs[i]``."""
    paths = [_Path()] + [_Path(low) for low in lower]
    lens = [len(s) for s in seqs]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    tokens = torch.from_numpy(np.concatenate(seqs).astype(np.int64)).to(device)
    with _exact():
        b = W.base(sz, seed, device)
        emb = b["embed"][tokens].float()
        xs = [emb.clone() for _ in paths]
        del emb
        for li in range(sz.n_layers):
            p = _f32(W.layer(sz, seed, li, device))
            for path, x in zip(paths, xs):
                h = rms_norm(x, p["norm1"], sz.norm_eps)
                a = torch.cat([attention(sz, path, p["attn"], h[bounds[i]:bounds[i + 1]])
                               for i in range(len(seqs))])
                x += a
                x += moe(sz, path, p["moe"], rms_norm(x, p["norm2"], sz.norm_eps))
            del p
        rows = torch.from_numpy(np.concatenate(
            [bounds[i] + np.asarray(w, np.int64) for i, w in enumerate(want)])).to(device)
        head = b["lm_head"].float()
        out = []
        for path, x in zip(paths, xs):
            lg = path.mm(rms_norm(x[rows], b["final_norm"].float(), sz.norm_eps), head)
            splits = np.cumsum([len(w) for w in want])[:-1].tolist()
            out.append(list(torch.tensor_split(lg, splits)))
    return out


@dataclass
class Verdict:
    """What the comparison read, over every compared token: the gaps of the
    served tokens' logits below the reference's best (``gaps``), how many
    served tokens were the reference's first (``agree``); for each lower
    precision, the gaps of the tokens it puts first and how many of those
    were the reference's first (``lower``)."""

    gaps: List[float]
    agree: int
    lower: Dict[str, Tuple[List[float], int]] = field(default_factory=dict)

    @property
    def tokens(self) -> int:
        return len(self.gaps)

    def numbers(self, low: Optional[str] = None) -> Dict[str, float]:
        """The numbers a limit may hold, of the program's tokens (``low``
        None) or of a lower precision's: the widest, mean and
        99th-percentile gap, and the share of tokens that are not the
        reference's first."""
        g, agree = (self.gaps, self.agree) if low is None else self.lower[low]
        g = np.asarray(g, np.float64)
        return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
                "p99_logit_gap": float(np.quantile(g, 0.99)),
                "off_first_share": 1.0 - agree / g.size}


def judge(sz: Sizes, seed: int, prompts: Sequence[np.ndarray],
          served: Sequence[np.ndarray], device, lower: Sequence[str] = ()) -> Verdict:
    """Hold each request's served tokens (the first one from its prefill)
    to the reference over its prompt and the tokens before it."""
    seqs, want = [], []
    for p, t in zip(prompts, served):
        p, t = np.asarray(p), np.asarray(t)
        seqs.append(np.concatenate([p, t[:-1]]))
        want.append(np.arange(len(p) - 1, len(p) - 1 + len(t)))
    outs = logits(sz, seed, seqs, want, device, lower)
    v = Verdict([], 0, {low: ([], 0) for low in lower})
    for i, t in enumerate(served):
        ref = outs[0][i]
        best, first = ref.max(-1)
        for k, low in enumerate((None,) + tuple(lower)):
            tt = (torch.as_tensor(np.asarray(t, np.int64), device=ref.device) if low is None
                  else outs[k][i].argmax(-1))
            gaps = (best - ref.gather(1, tt[:, None])[:, 0]).tolist()
            agree = int((first == tt).sum())
            if low is None:
                v.gaps.extend(gaps)
                v.agree += agree
            else:
                g, a = v.lower[low]
                v.lower[low] = (g + gaps, a + agree)
    return v
