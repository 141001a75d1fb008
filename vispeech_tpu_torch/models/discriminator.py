"""Multi-period and multi-scale waveform discriminators
(``vispeech_tpu/models/discriminator.py``), plain PyTorch: the JAX package
runs them outside any Pallas kernel.

``DiscriminatorP(p)`` folds the wave into [T/p, p] (reflect-padding T to a
multiple of p) and applies 5 weight-norm Conv2d (k 5×1, stride 3×1, 32 →
128 → 512 → 1024 → 1024) and a 3×1 conv_post; ``DiscriminatorS`` is 6
grouped weight-norm Conv1d and a conv_post.  Leaky ReLU 0.1 after every
conv but the last; every activation is returned for the feature loss.
Real and fake waves run through each discriminator as one batch.
Parameter names follow the reference ``MultiPeriodDiscriminator``:
``discriminators.0`` is the scale discriminator, ``discriminators.{1..5}``
the periods 2, 3, 5, 7, 11.  Waves are [B, T, 1]; inside, channel-first.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.layers import WNConv1d, _empty, _weight_norm, leaky_relu

PERIODS = (2, 3, 5, 7, 11)


class WNConv2d(nn.Module):
    """Weight-normalised Conv2d: ``weight_g`` [cout, 1, 1, 1], ``weight_v``
    [cout, cin, kh, kw], norm per output channel (ε = 1e-12 in the root)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.weight_g = _empty(cout, 1, 1, 1)
        self.weight_v = _empty(cout, cin, *kernel)
        self.bias = _empty(cout)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        w = _weight_norm(self.weight_v, self.weight_g, (1, 2, 3)).to(x.dtype)
        return F.conv2d(x, w, self.bias.to(x.dtype), self.stride, self.padding)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            WNConv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), (pad, 0))
            for i in range(4))
        self.convs.append(WNConv2d(1024, 1024, (kernel_size, 1), (1, 1), (pad, 0)))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, T] → (logits [B, n], feature maps)."""
        B, C, T = x.shape
        if T % self.period:
            n_pad = self.period - T % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            T += n_pad
        x = x.reshape(B, C, T // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20), (64, 256, 41, 4, 16, 20),
             (256, 1024, 41, 4, 64, 20), (1024, 1024, 41, 4, 256, 20),
             (1024, 1024, 5, 1, 1, 2))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(cin, cout, k, padding=pad, stride=s, groups=groups)
            for cin, cout, k, s, groups, pad in self.SPECS)
        self.conv_post = WNConv1d(1024, 1, 3, padding=1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv.forward_cf(x), 0.1)
            fmap.append(x)
        x = self.conv_post.forward_cf(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = PERIODS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, T, 1] → (real logits, fake logits, real feature maps,
        fake feature maps), one list entry per discriminator."""
        B = y.shape[0]
        both = torch.cat([y, y_hat], dim=0).transpose(1, 2)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            logit, fmap = d(both)
            y_d_rs.append(logit[:B])
            y_d_gs.append(logit[B:])
            fmap_rs.append([f[:B] for f in fmap])
            fmap_gs.append([f[B:] for f in fmap])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
