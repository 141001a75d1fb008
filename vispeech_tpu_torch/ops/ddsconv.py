"""Dilated depthwise-separable conv stack (``vispeech_tpu/ops/ddsconv.py``)
with the reference's module names.  Layout [B, T, C]."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.layers import Conv1d, LayerNorm


class DDSConv(nn.Module):
    """``g`` added first, then per layer i: depthwise conv (dilation kⁱ, SAME
    padding) → LN → exact GELU → 1×1 conv → LN → exact GELU → dropout, as a
    residual; the output masked."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.convs_sep = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=kernel_size ** i,
                   groups=channels) for i in range(n_layers))
        self.convs_1x1 = nn.ModuleList(Conv1d(channels, channels, 1) for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, norm1, pw, norm2 in zip(self.convs_sep, self.norms_1, self.convs_1x1,
                                         self.norms_2):
            y = F.gelu(norm1(sep(x * x_mask)))
            y = F.gelu(norm2(pw(y)))
            x = x + self.drop(y)
        return x * x_mask
