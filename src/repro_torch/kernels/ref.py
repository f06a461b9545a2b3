"""Plain PyTorch versions of every kernel (the CPU path and the allclose
targets the CUDA kernels are held to)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _zero_rows_past(out: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero capacity rows ``c >= counts[e]`` of an (E, C, N) output, the
    rows the kernels skip and write as zeros."""
    if counts is None:
        return out
    rows = torch.arange(out.shape[1], device=out.device)
    live = rows[None, :] < counts.to(out.device)[:, None]
    return out * live[..., None].to(out.dtype)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> (E, C, N), f32 accumulation, out in x's
    dtype.  Rows ``c >= counts[e]`` are zero when ``counts`` is given."""
    out = torch.matmul(x.float(), w.float()).to(x.dtype)
    return _zero_rows_past(out, counts)


def expert_gate_up_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h = silu(x@wg) * (x@wu), f32 accumulation, rounded to x's dtype."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return _zero_rows_past(h, counts)


def expert_ffn_ref(x: torch.Tensor, wg, wu, wd,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated expert FFN silu(x@wg) * (x@wu) @ wd, with h rounded to x's
    dtype between the two products (where the fused TPU kernel rounds it)."""
    h = expert_gate_up_ref(x, wg, wu, counts)
    return grouped_matmul_ref(h, wd, counts)


def decode_attention_ref(
    q: torch.Tensor,       # (B, H, D)
    k: torch.Tensor,       # (B, S, K, D)
    v: torch.Tensor,       # (B, S, K, D)
    pos,                   # int or (B,) int: row b attends slots <= pos[b]
) -> torch.Tensor:
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * (D ** -0.5)
    posv = torch.as_tensor(pos, device=q.device).reshape(-1, 1)  # (B|1, 1)
    valid = torch.arange(S, device=q.device)[None, :] <= posv    # (B|1, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def gather_pages(pk: torch.Tensor, ek: Optional[torch.Tensor], frames: torch.Tensor,
                 span: int) -> torch.Tensor:
    """The contiguous (n, span, K, hd) copy of n rows kept in pages: row b's
    page i is frame ``frames[b, i]`` of the device pool ``pk`` (P + 1, pt, K,
    hd) or, from index P + 1 on, of the window's frames ``ek``."""
    allk = pk if ek is None else torch.cat([pk, ek], dim=0)
    n, pages = frames.shape
    g = allk[frames.long().reshape(-1)]
    return g.reshape((n, pages * pk.shape[1]) + tuple(pk.shape[2:]))[:, :span]


def decode_attention_paged_ref(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                               ek: Optional[torch.Tensor], ev: Optional[torch.Tensor],
                               frames: torch.Tensor, pos, span: int) -> torch.Tensor:
    """K3p's plain version: gather each row's span through the page table,
    then ``decode_attention_ref``."""
    return decode_attention_ref(q, gather_pages(pk, ek, frames, span),
                                gather_pages(pv, ev, frames, span), pos)


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                               split: int, partials: bool = False):
    """The split design's arithmetic in plain PyTorch (used by tests only).

    A row's slots are cut into ``split``-slot splits by slot index alone;
    each split keeps its max m (of the scores times hd**-0.5 * log2(e)),
    its sum l of exp2(score - m) over valid slots and its unnormalised
    accumulator; then the partials merge by log-sum-exp in split order,
    skipping empty splits.  Slots past ``n = min(pos + 1, S)`` count as
    zero K and V rows with masked scores; a row with ``pos < 0`` comes back
    as zeros (``decode_attention_ref`` spreads it evenly instead).  With
    ``partials``, also returns (m, l, acc) of shapes (B, H, nsplit) and
    (B, H, nsplit, hd)."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    posv = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B).long()
    n = torch.clamp(posv + 1, min=0, max=S)
    valid = torch.arange(S, device=q.device)[None, :] < n[:, None]        # (B, S)
    kf = torch.where(valid[:, :, None, None], k.float(), torch.zeros((), device=q.device))
    vf = torch.where(valid[:, :, None, None], v.float(), torch.zeros((), device=q.device))
    scale_log2 = D ** -0.5 * 1.4426950408889634
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, K, G, D).float(), kf) * scale_log2
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    ms, ls, accs = [], [], []
    for lo in range(0, S, split):
        hi = min(lo + split, S)
        m = s[..., lo:hi].amax(-1)                                       # -inf: empty
        m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp2(s[..., lo:hi] - m_use[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, vf[:, lo:hi]))
    M = torch.stack(ms, -1).amax(-1)
    L = torch.zeros_like(M)
    A = torch.zeros((B, K, G, D), device=q.device)
    for m, l, acc in zip(ms, ls, accs):                                  # split order
        f = torch.where(l > 0, torch.exp2(m - M), torch.zeros_like(M))
        L = L + l * f
        A = A + acc * f[..., None]
    live = (n > 0)[:, None, None, None]
    out = torch.where(live, A / torch.where(L > 0, L, torch.ones_like(L))[..., None],
                      torch.zeros_like(A))
    out = out.reshape(B, H, D).to(q.dtype)
    if not partials:
        return out
    m = torch.stack(ms, -1).reshape(B, H, -1)
    l = torch.stack(ls, -1).reshape(B, H, -1)
    acc = torch.stack(accs, -2).reshape(B, H, -1, D)
    return out, (m, l, acc)


def flash_attention_ref(
    q: torch.Tensor,       # (B, S, H, D)
    k: torch.Tensor,       # (B, q_offset + S, K, D), H % K == 0: head h reads KV head h // G
    v: torch.Tensor,       # (B, q_offset + S, K, D)
    window: int = 0,
    lengths: Optional[torch.Tensor] = None,   # (B,) int: valid prefix per row
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal GQA attention, materialised f32 softmax, scale D**-0.5.

    Query row r is absolute position ``i = q_offset + r``; it sees key j
    iff ``j <= i``, ``i - window < j`` (when ``window``) and ``j <
    lengths[b]`` (when ``lengths``); output rows with ``i >= lengths[b]``
    are zeros (the kernel skips them).  The twin of the JAX package's
    ``kernels/ref.py::flash_attention_ref`` extended by window, lengths and
    the query offset of ``models/attention.py::naive_attention``.  Queries
    go in chunks so the (B, K, G, chunk, Sk) scores stay near 256 MB; each
    query row is computed whole, so the chunking changes no value."""
    B, S, H, D = q.shape
    K, Sk = k.shape[2], k.shape[1]
    G = H // K
    dev = q.device
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Sk, device=dev)
    lens = None if lengths is None else torch.as_tensor(lengths, device=dev).reshape(B)
    chunk = max(1, min(S, (1 << 26) // max(1, B * H * Sk)))
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        qf = q[:, lo:hi].reshape(B, hi - lo, K, G, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * (D ** -0.5)
        qpos = torch.arange(lo, hi, device=dev) + q_offset
        mask = kpos[None, :] <= qpos[:, None]                    # (q, Sk)
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        mask = mask[None]                                        # (1|B, q, S)
        if lens is not None:
            mask = mask & (kpos[None, None, :] < lens[:, None, None])
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        out[:, lo:hi] = o.reshape(B, hi - lo, H, D)
    if lens is not None:
        qpos = torch.arange(S, device=dev) + q_offset
        live = qpos[None, :] < lens[:, None]                     # (B, S)
        out = out * live[:, :, None, None]
    return out.to(q.dtype)


def ssd_scan_ref(
    x: torch.Tensor,        # (B, S, nh, hp)
    B: torch.Tensor,        # (B, S, ns), shared by every head
    C: torch.Tensor,        # (B, S, ns)
    dt: torch.Tensor,       # (B, S, nh) f32
    A: torch.Tensor,        # (nh,) f32, negative
    chunk: int,
    lengths: Optional[torch.Tensor] = None,   # (B,) int: valid prefix per row
):
    """Mamba2 SSD chunked scan.  Returns (y (B, S, nh, hp) in x's dtype,
    final state (B, nh, ns, hp) f32).

    The twin of the JAX package's ``models.ssm.ssd_scan`` / ``_chunk_math``:
    a Python loop over chunks of ``chunk`` positions, all in f32, the
    intra-chunk decay ``L = exp(cum_i - cum_j)`` masked to j <= i before the
    exp, and the state carried in f32 from chunk to chunk.  One difference:
    ``cum`` (the prefix sums of ``dt * A`` inside a chunk) is summed in f64
    and each difference rounded to f32, so that the exponent keeps f32
    precision where |cum| reaches the thousands (the reference's f32 prefix
    sums lose about 1e-4 of it over a 256-long chunk); the kernel does the
    same, so the two agree to f32 rounding at any chunk length.

    Positions at or past ``lengths[b]`` (and the pad of a last chunk shorter
    than ``chunk``) are padding: their x, B, C and dt count as zero, so the
    state is the state at ``lengths[b]``, and their y rows are zeros.
    Chunks wholly past ``lengths[b]`` leave the state as it is (exactly
    what skipping them, as the kernel does, gives)."""
    return _ssd_scan(x, B, C, dt, A, chunk, lengths, mma=False)


def ssd_scan_mma_ref(x, B, C, dt, A, chunk: int, lengths=None):
    """The ``mma`` design's arithmetic in plain PyTorch (used by tests
    only): ``ssd_scan_ref`` with the kernel's roundings.  The three f32
    operands of the tensor-core products, M = (C B^T) o L o dt, the state H
    entering a chunk (the C H operand) and the state update's w_j x_j, each
    enter as two bf16 terms hi = bf16(v) and lo = bf16(v - hi); products
    accumulate in f32 and ``cum`` is summed in f64, as in the plain
    version."""
    return _ssd_scan(x, B, C, dt, A, chunk, lengths, mma=True)


def _ssd_scan(x, B, C, dt, A, chunk: int, lengths, mma: bool):
    Bt, S, nh, hp = x.shape
    dev = x.device
    pos = torch.arange(S, device=dev)
    if lengths is None:
        lens = torch.full((Bt,), S, device=dev, dtype=torch.long)
    else:
        lens = torch.as_tensor(lengths, device=dev).reshape(-1).expand(Bt).long()
        lens = lens.clamp(0, S)
    # rows in groups so that a (rows, Q, Q, nh) f32 intermediate stays near 1 GB
    g = max(1, (1 << 28) // max(1, chunk * chunk * nh))
    ys, hs = [], []
    for lo in range(0, Bt, g):
        hi = min(Bt, lo + g)
        y, h = _ssd_rows(x[lo:hi], B[lo:hi], C[lo:hi], dt[lo:hi], A, chunk,
                         lens[lo:hi], pos, mma)
        ys.append(y)
        hs.append(h)
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    h = hs[0] if len(hs) == 1 else torch.cat(hs)
    return y.to(x.dtype), h


def _hi_lo(t: torch.Tensor):
    """f32 ``t`` as two bf16-valued f32 terms: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _ssd_rows(x, B, C, dt, A, chunk: int, lens, pos, mma: bool):
    Bt, S, nh, hp = x.shape
    ns = B.shape[-1]
    live = pos[None, :] < lens[:, None]                          # (Bt, S)
    xf = x.float() * live[..., None, None]
    Bf = B.float() * live[..., None]
    Cf = C.float() * live[..., None]
    dtf = dt.float() * live[..., None]
    Af = A.float()
    n_chunks = -(-int(lens.max()) // chunk) if Bt else 0
    y = torch.zeros((Bt, S, nh, hp), dtype=torch.float32, device=x.device)
    H = torch.zeros((Bt, nh, ns, hp), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        lo, hi = c * chunk, min(S, (c + 1) * chunk)
        q = hi - lo
        x_c, B_c, C_c, dt_c = xf[:, lo:hi], Bf[:, lo:hi], Cf[:, lo:hi], dtf[:, lo:hi]
        cum = torch.cumsum((dt_c * Af).double(), dim=1)         # (Bt, q, nh) f64
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).float()  # (Bt, i, j, nh)
        diff = torch.where(causal[None, :, :, None], diff,
                           torch.full_like(diff, NEG_INF))          # mask BEFORE exp
        L = torch.exp(diff)
        CB = torch.einsum("bis,bjs->bij", C_c, B_c)
        M = CB[..., None] * L * dt_c[:, None, :, :]
        del diff, L
        w = torch.exp((cum[:, -1:] - cum).float()) * dt_c       # (Bt, q, nh)
        wx = x_c * w[..., None]
        if mma:                                                 # hi + lo bf16 terms
            y_intra = sum(torch.einsum("bijn,bjnp->binp", t, x_c) for t in _hi_lo(M))
            y_inter = sum(torch.einsum("bis,bnsp->binp", C_c, t) for t in _hi_lo(H))
            S_c = sum(torch.einsum("bjs,bjnp->bnsp", B_c, t) for t in _hi_lo(wx))
        else:
            y_intra = torch.einsum("bijn,bjnp->binp", M, x_c)
            y_inter = torch.einsum("bis,bnsp->binp", C_c, H)
            S_c = torch.einsum("bjs,bjnp->bnsp", B_c, wx)
        del M
        y_inter = y_inter * torch.exp(cum.float())[..., None]
        H = H * torch.exp(cum[:, -1].float())[:, :, None, None] + S_c
        y[:, lo:hi] = y_intra + y_inter
    return y * live[..., None, None], H
