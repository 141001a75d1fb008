"""Prosody heads (``vispeech_tpu/models/predictors.py``): duration, pitch
(6-layer relative-attention encoder) and energy (FastSpeech2 variance
stack).  Layout [B, T, C].

Training follows the reference: dropout 0.5 after each layer norm of the
duration and variance stacks (``nn.Dropout``, off in eval mode); the
duration and pitch heads see their input and speaker embedding detached,
the energy head only its speaker embedding (``predictors.py:47-49,
111-114, 203-205, 259`` of the JAX package)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.attention import Encoder
from vispeech_tpu_torch.ops.layers import Conv1d, LayerNorm


class DurationPredictor(nn.Module):
    """2 × (conv k → relu → LN) → 1-channel projection of log(d + 1)."""

    def __init__(self, in_channels: int, filter_channels: int = 256,
                 kernel_size: int = 3, gin_channels: int = 0, p_dropout: float = 0.5):
        super().__init__()
        self.cond = Conv1d(gin_channels, in_channels, 1) if gin_channels else None
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask, g=None):
        """x [B, N, H], x_mask [B, N, 1] → logw [B, N, 1]."""
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        x = self.drop(self.norm_1(F.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(F.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


class PitchPredictor(nn.Module):
    """Relative-attention encoder → normalised log-F0 per phoneme."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 kernel_size: int, gin_channels: int = 0, n_layers: int = 6,
                 p_dropout: float = 0.0):
        super().__init__()
        self.cond = Conv1d(gin_channels, hidden_channels, 1) if gin_channels else None
        self.pitch_net = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                                 kernel_size, p_dropout=p_dropout)
        self.proj_f0 = Conv1d(hidden_channels, 1, 1)

    def forward(self, x, x_mask, g=None, generator=None):
        """→ lf0 [B, N]."""
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        x = self.pitch_net(x * x_mask, x_mask, generator) * x_mask
        return self.proj_f0(x)[..., 0]


class _ConvNorm(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.conv = Conv1d(cin, cout, kernel_size)

    def forward(self, x):
        return self.conv(x)


class _ConvLayer(nn.Module):
    def __init__(self, input_size: int, filter_size: int, kernel: int, p_dropout: float):
        super().__init__()
        self.conv_1 = _ConvNorm(input_size, filter_size, kernel)
        self.layer_norm_1 = nn.LayerNorm(filter_size, eps=1e-5)
        self.conv_2 = _ConvNorm(filter_size, filter_size, kernel)
        self.layer_norm_2 = nn.LayerNorm(filter_size, eps=1e-5)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x):
        x = self.drop(self._norm(self.layer_norm_1, F.relu(self.conv_1(x))))
        return self.drop(self._norm(self.layer_norm_2, F.relu(self.conv_2(x))))

    @staticmethod
    def _norm(ln: nn.LayerNorm, x):
        """LayerNorm statistics in f32, back in x's dtype (as the JAX LayerNorm)."""
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                            ln.bias.float(), ln.eps).to(x.dtype)


class VariancePredictor(nn.Module):
    """conv → relu → LN → conv → relu → LN → linear (reference names
    ``conv_layer.conv_1.conv``, ``conv_layer.layer_norm_1``, ``linear_layer``)."""

    def __init__(self, input_size: int, filter_size: int = 768, kernel: int = 3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.conv_layer = _ConvLayer(input_size, filter_size, kernel, p_dropout)
        self.linear_layer = nn.utils.skip_init(nn.Linear, filter_size, 1)

    def forward(self, x):
        return self.linear_layer(self.conv_layer(x))[..., 0]


class EnergyPredictor(nn.Module):
    """Speaker-conditioned variance stack → normalised energy [B, N]."""

    def __init__(self, input_size: int, gin_channels: int = 0):
        super().__init__()
        self.cond = Conv1d(gin_channels, input_size, 1) if gin_channels else None
        self.predictor = VariancePredictor(input_size)

    def forward(self, x, g: Optional[torch.Tensor] = None):
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        return self.predictor(x)
