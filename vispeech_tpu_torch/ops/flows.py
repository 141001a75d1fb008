"""Flow layers of the prior (``vispeech_tpu/ops/flows.py``): ``Flip`` and
the mean-only ``ResidualCouplingLayer``, forward (training: x → z_p) and
reverse (inference).  Layout [B, T, C]."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vispeech_tpu_torch.ops.layers import Conv1d
from vispeech_tpu_torch.ops.wavenet import WN


class Flip(nn.Module):
    """Channel flip (its own inverse)."""

    def forward(self, x, x_mask=None, g=None, reverse=False):
        return torch.flip(x, dims=[-1])


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling over a channel split, driven by a WN stack:
    forward x1 ← (m(x0) + x1)·mask, reverse x1 ← (x1 − m(x0))·mask."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1)
