"""Conformer encoder stack (``vispeech_tpu/models/conformer.py``): Macaron
half-step feed-forwards, Transformer-XL relative self-attention, the
convolution module and a final LayerNorm per block.  Layout [B, T, D].

Kept from the JAX package as it is: the LayerNorms' ε is flax's 1e-6; the
relative shift pads and reshapes a length-T sinusoidal table (not 2T − 1);
scores divide by √D, not √(D / heads); masked keys score −1e9.  The
convolution module's BatchNorm follows flax's ``BatchNorm(momentum=0.9)``:
in training it normalises with the batch's statistics over every frame
(padding included) and moves its running mean and variance 0.1 of the way
to the batch's, the variance biased (``torch.nn.BatchNorm1d`` would move
them with the unbiased one); in eval it uses the running statistics.
Dropout is ``nn.Dropout``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6   # flax nn.LayerNorm's default


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """[1, L, D] sinusoidal table: sin at even channels, cos at odd."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe[None].to(dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9)`` over the last axis (ε 1e-5):
    ``weight`` / ``bias``, buffers ``running_mean`` / ``running_var``."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class FeedForwardModule(nn.Module):
    """LN → linear ×expansion → swish → dropout → linear → dropout."""

    def __init__(self, dim: int, expansion_factor: int = 4, p_dropout: float = 0.1):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, dim * expansion_factor)
        self.linear2 = nn.Linear(dim * expansion_factor, dim)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(_swish(self.linear1(self.norm(x))))
        return self.drop(self.linear2(y))


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative attention with the u / v biases [H, d]."""

    def __init__(self, d_model: int, n_heads: int, p_dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        d_head = d_model // n_heads
        self.query_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model)
        self.value_proj = nn.Linear(d_model, d_model)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model)
        self.u_bias = nn.Parameter(torch.zeros(n_heads, d_head))
        self.v_bias = nn.Parameter(torch.zeros(n_heads, d_head))
        self.drop = nn.Dropout(p_dropout)

    @staticmethod
    def _relative_shift(pos_score: torch.Tensor) -> torch.Tensor:
        b, h, t1, t2 = pos_score.shape
        padded = F.pad(pos_score, (1, 0)).reshape(b, h, t2 + 1, t1)
        return padded[:, :, 1:].reshape(b, h, t1, t2)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D], pos_emb [1, T, D], mask [B, T] (1: valid)."""
        B, T, D = x.shape
        H = self.n_heads
        q = self.query_proj(x).reshape(B, T, H, D // H)
        k = self.key_proj(x).reshape(B, T, H, D // H).transpose(1, 2)
        v = self.value_proj(x).reshape(B, T, H, D // H).transpose(1, 2)
        p = self.pos_proj(pos_emb.expand(B, T, D)).reshape(B, T, H, D // H)
        content = torch.einsum("bthd,bhsd->bhts", q + self.u_bias, k)
        pos_score = torch.einsum("bthd,bshd->bhts", q + self.v_bias, p)
        score = (content + self._relative_shift(pos_score)) / math.sqrt(D)
        if mask is not None:
            score = score.masked_fill(~(mask[:, None, None, :] > 0), -1e9)
        attn = self.drop(torch.softmax(score, dim=-1))
        ctx = torch.einsum("bhts,bhsd->bthd", attn, v).reshape(B, T, D)
        return self.out_proj(ctx)


class MultiHeadedSelfAttentionModule(nn.Module):
    """LN → relative self-attention over a sinusoidal table → dropout."""

    def __init__(self, d_model: int, n_heads: int, p_dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attention = RelativeMultiHeadAttention(d_model, n_heads, p_dropout)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos = sinusoidal_positions(x.shape[1], self.d_model, x.dtype, x.device)
        return self.drop(self.attention(self.norm(x), pos, mask=mask))


class ConformerConvModule(nn.Module):
    """LN → pointwise ×2 → GLU → depthwise k (SAME, no bias) → BatchNorm →
    swish → pointwise → dropout.  Convs [cout, cin/groups, k]."""

    def __init__(self, dim: int, kernel_size: int = 31, expansion_factor: int = 2,
                 p_dropout: float = 0.1):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Conv1d(dim, dim * expansion_factor, 1)
        self.dw = nn.Conv1d(dim, dim, kernel_size, groups=dim, bias=False)
        self.bn = BatchNorm(dim)
        self.pw2 = nn.Conv1d(dim, dim, 1)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.norm(x).transpose(1, 2))
        y = F.glu(y, dim=1)
        k = self.dw.kernel_size[0]
        y = self.dw(F.pad(y, ((k - 1) // 2, k // 2))).transpose(1, 2)
        y = _swish(self.bn(y))
        return self.drop(self.pw2(y.transpose(1, 2)).transpose(1, 2))


class ConformerBlock(nn.Module):
    """x + ½·FF → + MHSA → + Conv → + ½·FF → LN."""

    def __init__(self, encoder_dim: int, n_heads: int = 8, ff_expansion: int = 4,
                 conv_expansion: int = 2, ff_dropout: float = 0.1, attn_dropout: float = 0.1,
                 conv_dropout: float = 0.1, conv_kernel_size: int = 31,
                 half_step_residual: bool = True):
        super().__init__()
        self.factor = 0.5 if half_step_residual else 1.0
        self.ff1 = FeedForwardModule(encoder_dim, ff_expansion, ff_dropout)
        self.mhsa = MultiHeadedSelfAttentionModule(encoder_dim, n_heads, attn_dropout)
        self.conv = ConformerConvModule(encoder_dim, conv_kernel_size, conv_expansion,
                                        conv_dropout)
        self.ff2 = FeedForwardModule(encoder_dim, ff_expansion, ff_dropout)
        self.norm = nn.LayerNorm(encoder_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.factor * self.ff1(x)
        x = x + self.mhsa(x, mask=mask)
        x = x + self.conv(x)
        x = x + self.factor * self.ff2(x)
        return self.norm(x)


class ConformerEncoder(nn.Module):
    """``n_layers`` ConformerBlocks (``blocks.i``), the output re-masked
    after each."""

    def __init__(self, encoder_dim: int, n_layers: int = 4, n_heads: int = 8,
                 conv_kernel_size: int = 31, p_dropout: float = 0.1):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConformerBlock(encoder_dim, n_heads=n_heads, ff_dropout=p_dropout,
                           attn_dropout=p_dropout, conv_dropout=p_dropout,
                           conv_kernel_size=conv_kernel_size)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D], x_mask [B, T, 1] or None → [B, T, D]."""
        mask = None if x_mask is None else x_mask[..., 0]
        for block in self.blocks:
            x = block(x, mask=mask)
            if x_mask is not None:
                x = x * x_mask
        return x
