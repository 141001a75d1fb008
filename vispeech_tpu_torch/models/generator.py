"""HiFi-GAN upsampling vocoder (``vispeech_tpu/models/generator.py``).

conv_pre k7 → + speaker cond → 4 × [leaky 0.1 → weight-norm ConvTranspose
→ mean of the 3 MRF branches] → leaky 0.01 → conv_post k7 (no bias) → tanh.
Runs channel-first inside and in the dtype of its input.  With ResBlock1
and ``fused`` (serving) the 64-channel MRF stage goes through kernel C's
wrapper (``ops/kernels/mrf_stage.py``: the kernel on a CUDA tensor, its
plain version on a CPU tensor); the other stages run the plain ResBlock1.
Training passes ``fused=False``: kernel C has no backward, and every stage
runs the plain, differentiable ResBlock1 (the JAX trainer's folded MRF
computes the same math).  ``tail_f32`` runs the last leaky ReLU, conv_post
and tanh in f32 whatever the body's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vispeech_tpu_torch.ops.kernels import mrf_stage
from vispeech_tpu_torch.ops.layers import Conv1d, WNConvTranspose1d, leaky_relu
from vispeech_tpu_torch.ops.resblock import ResBlock1, ResBlock2

KERNEL_CHANNELS = 64


class Generator(nn.Module):
    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 4, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 gin_channels: int = 0):
        super().__init__()
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.fused_mrf = resblock == "1"
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)
        block = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.channels = []
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.channels.append(ch)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, u))
            for rk, rd in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(block(ch, rk, rd))
        self.conv_post = Conv1d(self.channels[-1], 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None, fused: bool = True,
                tail_f32: bool = False) -> torch.Tensor:
        """x [B, T, C_in], g [B, 1, G] → audio [B, T·Π rates, 1]."""
        n = len(self.kernel_sizes)
        x = self.conv_pre.forward_cf(x.transpose(1, 2))
        if g is not None and self.cond is not None:
            x = x + self.cond.forward_cf(g.transpose(1, 2))
        for i, (up, ch) in enumerate(zip(self.ups, self.channels)):
            x = up.forward_cf(leaky_relu(x, 0.1))
            blocks = self.resblocks[i * n:(i + 1) * n]
            if fused and self.fused_mrf and ch == KERNEL_CHANNELS:
                y = mrf_stage.mrf_stack(x.transpose(1, 2), [b.packed() for b in blocks],
                                        self.kernel_sizes, self.dilations)
                x = y.transpose(1, 2)
            else:
                acc = None
                for b in blocks:
                    y = b.forward_cf(x)
                    acc = y if acc is None else acc + y
                x = acc / n
        if tail_f32:
            x = x.float()
        x = self.conv_post.forward_cf(leaky_relu(x, 0.01))
        return torch.tanh(x).transpose(1, 2)
