"""Kernel A: masked self-attention with a window-w relative-position bias.

Replaces ``vispeech_tpu/ops/pallas/flash_attention.py::relative_self_attention``
(body ``_attention_kernel``) with ``csrc/rel_attention.cu``: one block per
(batch·head, 32 query rows), K/V streamed in 32-key tiles with an online
softmax, the relative-value band carried in the P·V accumulator.  It is
compute-bound (4·T²·d flops per batch-head against T·d·16 bytes) and runs
on the f32 CUDA cores in this version.

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


def relative_self_attention(q, k, v, rel_k, rel_v, key_mask, window: int = 4):
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor."""
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
    if key_mask.shape != (B, T):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(B, T)}")
    args = [t.contiguous().float() for t in (q, k, v, rel_k, rel_v, key_mask)]
    for t in args:
        if t.device != q.device:
            raise ValueError("rel_attention inputs must share one device")
    out = torch.empty_like(args[0])
    lib = _build.load("rel_attention")
    fn = lib.rel_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    status = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, H, T, d, n_rel,
                window, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rel_attention")
    launches += 1
    return out.to(q.dtype)
