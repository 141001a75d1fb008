"""Masks, segment slicing, the monotonic alignment path and the gradient
norm (``vispeech_tpu/ops/masking.py``).

Layout: sequences [B, T, C], masks [B, T, 1] float.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths → [B, T] bool mask."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def length_mask(lengths: torch.Tensor, max_length: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] lengths → [B, T, 1] float mask."""
    return sequence_mask(lengths, max_length)[..., None].to(dtype)


def intersperse(seq, item):
    """[a, b] → [item, a, item, b, item] (blank interleaving, on the host)."""
    out = [item] * (len(seq) * 2 + 1)
    out[1::2] = seq
    return out


def subsequent_mask(length: int) -> torch.Tensor:
    """[1, 1, T, T] lower-triangular causal mask (f32)."""
    return torch.tril(torch.ones(length, length))[None, None]


def generate_path(duration: torch.Tensor, t_frames: int) -> torch.Tensor:
    """Durations [B, N] → bool alignment path [B, T, N]:
    path[b, t, n] = cum[n−1] ≤ t < cum[n]."""
    ends = torch.cumsum(duration, dim=1)
    starts = ends - duration
    t = torch.arange(t_frames, device=duration.device, dtype=ends.dtype)[None, :, None]
    return (t >= starts[:, None, :]) & (t < ends[:, None, :])


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """x [B, T, C], start indices [B] (on x's device) → [B, S, C] by one
    gather, with no host sync."""
    idx = ids_str.long()[:, None] + torch.arange(segment_size, device=x.device)[None]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor, segment_size: int,
                        generator=None, ids: torch.Tensor = None):
    """A random segment per utterance inside its valid length (start 0 when
    shorter than the segment) → (x segments [B, S, C], starts [B] int64).
    The uniform draws come from ``generator`` on x's device; ``ids`` injects
    the starts instead."""
    B, T, _ = x.shape
    if ids is None:
        max_start = torch.clamp(lengths - segment_size, min=0)
        u = torch.rand(B, generator=generator, device=x.device)
        ids = (u * (max_start + 1).float()).long()
        ids = torch.clamp(ids, max=max(T - segment_size, 0))
    ids = ids.to(x.device).long()
    return slice_segments(x, ids, segment_size), ids


def grad_global_norm(grads) -> torch.Tensor:
    """L2 norm over a collection of gradients (None entries skipped)."""
    gs = [g.float() for g in grads if g is not None]
    return torch.sqrt(sum(torch.sum(g * g) for g in gs))
