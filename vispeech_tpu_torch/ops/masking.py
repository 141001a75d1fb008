"""Masks and the monotonic alignment path (``vispeech_tpu/ops/masking.py``).

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


def generate_path(duration: torch.Tensor, t_frames: int) -> torch.Tensor:
    """Durations [B, N] → bool alignment path [B, T, N]:
    path[b, t, n] = cum[n−1] ≤ t < cum[n]."""
    ends = torch.cumsum(duration, dim=1)
    starts = ends - duration
    t = torch.arange(t_frames, device=duration.device, dtype=ends.dtype)[None, :, None]
    return (t >= starts[:, None, :]) & (t < ends[:, None, :])
