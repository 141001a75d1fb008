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
