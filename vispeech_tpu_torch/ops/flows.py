"""Flow layers (``vispeech_tpu/ops/flows.py``): ``Flip`` and the mean-only
``ResidualCouplingLayer`` of the prior, and ``Log``, ``ElementwiseAffine``
and the spline ``ConvFlow`` of the stochastic duration predictor.
Layout [B, T, C].

``Flip`` and the coupling return y in both directions (the prior needs no
log-det).  ``Log``, ``ElementwiseAffine`` and ``ConvFlow`` return
(y, logdet [B]) forward and y in reverse, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vispeech_tpu_torch.ops.ddsconv import DDSConv
from vispeech_tpu_torch.ops.layers import Conv1d
from vispeech_tpu_torch.ops.spline import piecewise_rational_quadratic_transform
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


class Log(nn.Module):
    """y = log(max(x, 1e-5))·mask, log-det −Σy; reverse exp(x)·mask."""

    def forward(self, x, x_mask, g=None, reverse=False):
        if reverse:
            return torch.exp(x) * x_mask
        y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))


class ElementwiseAffine(nn.Module):
    """Per-channel affine y = (m + e^logs·x)·mask; ``m`` and ``logs``
    [channels, 1] as in the reference."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        m, logs = self.m[:, 0], self.logs[:, 0]
        if reverse:
            return (x - m) * torch.exp(-logs) * x_mask
        y = (m + torch.exp(logs) * x) * x_mask
        return y, torch.sum(logs * x_mask, dim=(1, 2))


class ConvFlow(nn.Module):
    """Half-split coupling: the second half through a rational-quadratic
    spline (linear tails at ``tail_bound``) whose K bins are computed from
    the first half by 1×1 conv → DDSConv → 1×1 conv."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        B, T, _ = x0.shape
        K = self.num_bins
        h = h.reshape(B, T, self.half, 3 * K - 1)
        denom = math.sqrt(self.filter_channels)
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :K] / denom, h[..., K:2 * K] / denom, h[..., 2 * K:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        y = torch.cat([x0, x1], dim=-1) * x_mask
        if reverse:
            return y
        return y, torch.sum(logabsdet * x_mask, dim=(1, 2))
