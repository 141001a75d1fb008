"""HiFi-GAN residual blocks (``vispeech_tpu/ops/resblock.py``).

The decoder runs them channel-first: ``forward_cf`` takes [B, C, T];
``forward`` takes [B, T, C] like the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from vispeech_tpu_torch.ops.layers import WNConv1d, leaky_relu

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    """Units of [leaky → dilated conv → leaky → conv] + residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=1) for _ in dilation)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1.forward_cf(leaky_relu(x, LRELU_SLOPE))
            xt = c2.forward_cf(leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_cf(x.transpose(1, 2)).transpose(1, 2)

    def packed(self) -> Tuple[torch.Tensor, ...]:
        """Effective weights for kernel C: (w1 [U, k, C, C], b1 [U, 1, C], w2,
        b2), w[u, tap, cin, cout]; whole, gathered over the model axis when
        the convs are sharded."""
        def stack(convs):
            w = torch.stack([c.weight.permute(2, 1, 0) for c in convs])
            b = torch.stack([c.bias.float()[None] for c in convs])
            return w, b

        return (*stack(self.convs1), *stack(self.convs2))


class ResBlock2(nn.Module):
    """Units of [leaky → dilated conv] + residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d) for d in dilation)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c.forward_cf(leaky_relu(x, LRELU_SLOPE)) + x
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_cf(x.transpose(1, 2)).transpose(1, 2)
