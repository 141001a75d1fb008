"""Kernel A: masked self-attention with a window-w relative-position bias.

Replaces ``vispeech_tpu/ops/pallas/flash_attention.py::relative_self_attention``
(body ``_attention_kernel``) with ``csrc/rel_attention.cu``: one CTA of 4
warps per (batch·head, 64 query rows, key split), K/V streamed in 32-key
tiles with an online softmax, QKᵀ and P·V on the tensor cores in TF32 with
the 3-pass hi/lo split (f32 accuracy), the relative-value band kept per row
and added at the end.  When batch·heads·⌈T/64⌉ CTAs would leave the card
idle the keys are split across CTAs (``key_splits``) and a second small
kernel merges the partials as ``relative_self_attention_split`` does.
Compute-bound: 4·T²·d flops per batch-head against T·d·16 bytes.

q, k and v are read through their strides and the output is written as
[B, T, H, d], returned as the [B, H, T, d] view: the projections' layout.
Only key positions are masked (fill −1e4, not −inf), as in the TPU kernel;
the unfused path masks the query × key outer product, so the two agree on
valid query rows.  Rows whose keys are all masked stay finite.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

NEG_FILL = -1e4
launches = 0

BQ, BK = 64, 32          # query rows per CTA, keys per tile (csrc/rel_attention.cu)
TARGET_CTAS = 264        # two CTAs on each of the H100's 132 SMs
MIN_SPLIT_TILES = 2      # key tiles a split keeps at least


def key_splits(batch: int, heads: int, T: int) -> int:
    """Key splits per (batch·head, 64 query rows): enough to bring the grid
    near ``TARGET_CTAS``, each split keeping at least ``MIN_SPLIT_TILES``
    32-key tiles, and none empty."""
    tiles = -(-T // BK)
    base = batch * heads * -(-T // BQ)
    splits = max(1, min(tiles // MIN_SPLIT_TILES, TARGET_CTAS // base))
    per_split = -(-tiles // splits)
    return -(-tiles // per_split)


def launch_grid(batch: int, heads: int, T: int) -> dict:
    """The grid of a launch: CTAs, cluster size and key splits."""
    splits = key_splits(batch, heads, T)
    return {"ctas": -(-T // BQ) * batch * heads * splits, "cluster": 1, "splits": splits}


def relative_self_attention_plain(q, k, v, rel_k, rel_v, key_mask, window: int = 4):
    """q, k, v [B, H, T, d]; rel_k, rel_v [n_rel, 2w+1, d]; key_mask [B, T]
    → [B, H, T, d], all f32."""
    T, d = q.shape[2], q.shape[3]
    qs = q * (1.0 / math.sqrt(d))
    scores = torch.matmul(qs, k.transpose(-1, -2))
    rel_logits = torch.einsum("bhtd,hmd->bhtm", qs, rel_k.expand(q.shape[1], -1, -1))
    for delta in range(-window, window + 1):
        n = T - abs(delta)
        if n <= 0:
            continue
        rows = slice(max(-delta, 0), max(-delta, 0) + n)
        scores.diagonal(delta, -2, -1).add_(rel_logits[:, :, rows, delta + window])
    scores = torch.where(key_mask[:, None, None, :] > 0, scores,
                         torch.full_like(scores, NEG_FILL))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, v)
    rv = rel_v.expand(q.shape[1], -1, -1)
    for delta in range(-window, window + 1):
        n = T - abs(delta)
        if n <= 0:
            continue
        rows = slice(max(-delta, 0), max(-delta, 0) + n)
        band = p.diagonal(delta, -2, -1)  # [B, H, n]
        out[:, :, rows] += band[..., None] * rv[None, :, None, delta + window]
    return out


def relative_self_attention_split(q, k, v, rel_k, rel_v, key_mask, window: int = 4,
                                  splits: int = 1):
    """The kernel's key split in plain PyTorch: the keys cut into ``splits``
    runs of whole 32-key tiles; each run's partial row max m, row sum l and
    accumulator (its band's rel-v term included) computed on its own, then
    merged as the merge kernel does: out = Σ e^{m_s − M}·acc_s /
    Σ e^{m_s − M}·l_s, M = max_s m_s.  Shapes as the plain version."""
    B, H, T, d = q.shape
    qs = q * (1.0 / math.sqrt(d))
    scores = torch.matmul(qs, k.transpose(-1, -2))
    rel_logits = torch.einsum("bhtd,hmd->bhtm", qs, rel_k.expand(H, -1, -1))
    delta = torch.arange(T)[None, :] - torch.arange(T)[:, None]          # key − row
    in_band = delta.abs() <= window
    idx = (delta.clamp(-window, window) + window).expand(B, H, T, T)
    scores = scores + torch.where(in_band, torch.gather(rel_logits, 3, idx), 0.0)
    scores = torch.where(key_mask[:, None, None, :] > 0, scores,
                         torch.full_like(scores, NEG_FILL))
    rv = rel_v.expand(H, -1, -1)
    tiles = -(-T // BK)
    per_split = -(-tiles // splits)
    parts = []
    for s0 in range(0, tiles, per_split):
        keys = slice(s0 * BK, min((s0 + per_split) * BK, T))
        sc = scores[..., keys]
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        band = torch.where(in_band[:, keys], p, 0.0)
        # Σ_j band[t, j]·rel_v[j − t + w] = Σ_δ (band by δ)·rel_v[δ + w]
        by_delta = torch.zeros(B, H, T, 2 * window + 1, dtype=p.dtype)
        by_delta.scatter_add_(3, idx[..., keys], band)
        acc = torch.matmul(p, v[:, :, keys]) + torch.einsum("bhtm,hmd->bhtd", by_delta, rv)
        parts.append((m, p.sum(-1, keepdim=True), acc))
    mmax = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - mmax) * acc for m, _, acc in parts)
    den = sum(torch.exp(m - mmax) * l for m, l, _ in parts)
    return num / den


def _kernel_layout(q, k, v):
    """q, k and v as the kernel reads them: f32 [B, H, T, d] views with one
    set of strides, d contiguous, every row 16-byte aligned (the
    projections' [B, T, H, d] views are); else contiguous copies."""
    st = q.stride()
    if (q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32
            or st[3] != 1 or (st[0] | st[1] | st[2]) % 4 or k.stride() != st
            or v.stride() != st or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        q, k, v = (t.float().contiguous() for t in (q, k, v))
    return q, k, v


def relative_self_attention(q, k, v, rel_k, rel_v, key_mask, window: int = 4):
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor.  On the
    card the result is the [B, H, T, d] view of a [B, T, H, d] tensor."""
    if q.device.type == "cpu":
        return relative_self_attention_plain(q, k, v, rel_k, rel_v, key_mask, window)
    global launches
    refuse_autograd("rel_attention", "rel_attention_train.relative_self_attention_train",
                    q, k, v, rel_k, rel_v)
    B, H, T, d = q.shape
    n_rel = rel_k.shape[0]
    if d not in (64, 96) or window > 4 or n_rel not in (1, H):
        raise ValueError(f"rel_attention kernel takes d in (64, 96), window <= 4, "
                         f"n_rel in (1, H); got d={d}, window={window}, n_rel={n_rel}")
    if rel_k.shape != (n_rel, 2 * window + 1, d) or rel_v.shape != rel_k.shape:
        raise ValueError(f"rel tables {tuple(rel_k.shape)} / {tuple(rel_v.shape)}")
    if key_mask.shape != (B, T) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"key_mask {tuple(key_mask.shape)}")
    dtype = q.dtype
    q, k, v = _kernel_layout(q, k, v)
    tables = [t.contiguous().float() for t in (rel_k, rel_v, key_mask)]
    tables = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tables]   # cp.async rows
    for t in (k, v, *tables):
        if t.device != q.device:
            raise ValueError("rel_attention inputs must share one device")
    # [B, T, H, d] in memory, seen as [B, H, T, d]
    out = torch.empty_strided((B, H, T, d), (T * H * d, d, H * d, 1), device=q.device)
    splits = key_splits(B, H, T)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(splits, B * H, T, d, device=q.device)
        part_ml = torch.empty(splits, B * H, T, 2, device=q.device)
    fn = _build.function("rel_attention", "rel_attention_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
                *(t.data_ptr() for t in tables), out.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                B, H, T, d, n_rel, window, splits,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rel_attention")
    launches += 1
    return out if dtype == torch.float32 else out.to(dtype)
