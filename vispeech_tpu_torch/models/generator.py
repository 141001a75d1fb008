"""HiFi-GAN upsampling vocoder (``vispeech_tpu/models/generator.py``).

conv_pre k7 → + speaker cond → 4 × [leaky 0.1 → weight-norm ConvTranspose
→ mean of the 3 MRF branches] → leaky 0.01 → conv_post k7 (no bias) → tanh.
Runs channel-first inside and in the dtype of its input.  With ResBlock1
and ``fused`` (serving), as the JAX generator dispatches under
``fused_decode``: a stage narrower than 64 channels whose length divides by
fold = 128 // C goes through kernel D's wrapper (``ops/kernels/
mrf_stage_folded.py``, the polyphase-folded stage), the 64-channel stage
through kernel C's (``ops/kernels/mrf_stage.py``) — each the kernel on a
CUDA tensor, its plain version on a CPU tensor; the other stages run the
plain ResBlock1.  With frozen weight norms the generator prepares C's and
D's weights once and keeps them (``_kernel_weights``), so a serving request
packs no weights.  Training passes ``fused=False``: C and D have no
backward, and every stage runs the plain, differentiable ResBlock1 (the
JAX trainer's folded MRF computes the same math).  ``tail_f32`` runs the
last leaky ReLU, conv_post and tanh in f32 whatever the body's dtype.
Sharded on the model axis (``parallel/sharding.py``), conv_pre, the ups
and the ResBlock convs of stages of 64 channels or more run
column-parallel (``ops/layers.py``), and kernels C and D take the whole
weights that ``ResBlock1.packed`` gathers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vispeech_tpu_torch.ops.kernels import mrf_stage, mrf_stage_folded
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
        self._kernel_cache = {}   # stage → (key, frozen tensors, kernel C's or D's weights)

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
            fold = max(1, 128 // ch)
            if fused and self.fused_mrf and ch < KERNEL_CHANNELS and x.shape[-1] % fold == 0:
                prepared = self._kernel_weights(i, blocks, x, fold)
                packed = None if prepared is not None else [b.packed() for b in blocks]
                y = mrf_stage_folded.mrf_stack_folded(x.transpose(1, 2), packed,
                                                      self.kernel_sizes, self.dilations, fold,
                                                      prepared)
                x = y.transpose(1, 2)
            elif fused and self.fused_mrf and ch == KERNEL_CHANNELS:
                prepared = self._kernel_weights(i, blocks, x)
                packed = None if prepared is not None else [b.packed() for b in blocks]
                y = mrf_stage.mrf_stack(x.transpose(1, 2), packed, self.kernel_sizes,
                                        self.dilations, prepared)
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

    def _kernel_weights(self, stage: int, blocks, x: torch.Tensor, fold: Optional[int] = None):
        """Kernel C's (``fold`` None) or D's prepared weights for a stage on
        the card whose weight norms are frozen (``freeze_weight_norm``, as
        serving does), kept while those frozen tensors stay the same and
        unchanged in place; None otherwise (CPU, or weights that change:
        the wrapper prepares them at each call)."""
        convs = [c for b in blocks for c in (*b.convs1, *b.convs2)]
        if not _on_card(x) or any(c.folded is None for c in convs):
            return None
        tensors = [t for c in convs for t in (c.folded, c.bias)]
        key = (x.dtype, fold, tuple((id(t), t._version) for t in tensors))
        cached = self._kernel_cache.get(stage)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                packed = [b.packed() for b in blocks]
                if fold is None:
                    prepared = mrf_stage.prepare_weights(packed, self.kernel_sizes,
                                                         self.dilations, x.dtype)
                else:
                    prepared = mrf_stage_folded.prepare_weights(
                        packed, self.kernel_sizes, self.dilations, fold, x.shape[1], x.dtype)
            # the tensors stay referenced, so their ids cannot be reused
            cached = self._kernel_cache[stage] = (key, tensors, prepared)
        return cached[2]


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` runs the kernels (a CPU tensor runs the plain versions,
    which take the weights as they are)."""
    return x.device.type != "cpu"
