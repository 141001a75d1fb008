"""Device-side length regulator (``vispeech_tpu/ops/length_regulator.py``):
phoneme states expand to frames with one [B,T,N] × [B,N,C] product over the
alignment path, with no host round trip."""

from __future__ import annotations

from typing import Tuple

import torch

from vispeech_tpu_torch.ops.masking import generate_path


def length_regulate(x: torch.Tensor, duration: torch.Tensor,
                    t_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand x [B, N, C] by durations [B, N] → (frames [B, T, C], lengths [B]).

    Negative durations clamp to 0; frames past an utterance's total are zero;
    the frame length is the sum of the durations.
    """
    duration = torch.clamp(duration, min=0).to(torch.int32)
    path = generate_path(duration, t_frames).to(x.dtype)
    frames = torch.bmm(path, x)
    return frames, duration.sum(dim=1)


def length_regulate_gather(x: torch.Tensor, duration: torch.Tensor,
                           t_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``length_regulate`` by a gather of each frame's phoneme (a binary
    search over the cumulative durations) instead of the [T, N] product:
    the same frames on integer durations."""
    duration = torch.clamp(duration, min=0).to(torch.int32)
    ends = torch.cumsum(duration, dim=1)
    t = torch.arange(t_frames, dtype=ends.dtype, device=x.device)
    # phoneme owning frame t: #(ends <= t)
    idx = torch.searchsorted(ends, t.expand(ends.shape[0], -1).contiguous(), right=True)
    idx = torch.clamp(idx, 0, x.shape[1] - 1)
    frames = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    lengths = ends[:, -1]
    valid = (t[None, :] < lengths[:, None])[..., None]
    return frames * valid.to(x.dtype), lengths
