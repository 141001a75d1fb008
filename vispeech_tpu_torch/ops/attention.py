"""Relative-position multi-head self-attention, the conv FFN and the
post-norm encoder (``vispeech_tpu/ops/attention.py``).

When autograd needs gradients attention runs through kernel F's wrapper
(``ops/kernels/rel_attention_train.py``: forward and backward, dropout on
the probabilities at ``p_dropout`` in training mode), otherwise through
kernel A's (``ops/kernels/rel_attention.py``); each the kernel on a CUDA
tensor, its plain version on a CPU tensor.  Both mask key positions only;
the encoder re-masks every layer's output, so valid rows match the JAX
package's outer-product mask exactly.  The other dropout sites are
``nn.Dropout``: the FFN's activations and the encoder's attention and FFN
outputs.  A dropout seed for F comes from the caller's CPU ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.kernels import rel_attention, rel_attention_train
from vispeech_tpu_torch.ops.layers import Conv1d, LayerNorm


class MultiHeadAttention(nn.Module):
    """Self-attention with shared (``heads_share``) window-w relative
    key/value tables ``emb_rel_k`` / ``emb_rel_v`` [n_rel, 2w+1, d]."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, heads_share: bool = True, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.window_size = window_size
        d = channels // n_heads
        n_rel = 1 if heads_share else n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        self.emb_rel_k = nn.Parameter(torch.empty(n_rel, 2 * window_size + 1, d))
        self.emb_rel_v = nn.Parameter(torch.empty(n_rel, 2 * window_size + 1, d))

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor, generator=None) -> torch.Tensor:
        """x [B, T, C], key_mask [B, T] → [B, T, out]."""
        B, T, C = x.shape

        def heads(t):
            return t.reshape(B, T, self.n_heads, C // self.n_heads).transpose(1, 2)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        rel = (self.emb_rel_k.to(q.dtype), self.emb_rel_v.to(q.dtype))
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v) + rel):
            rate = self.p_dropout if self.training else 0.0
            seed = rel_attention_train.draw_seed(generator) if rate > 0.0 else 0
            out = rel_attention_train.relative_self_attention_train(
                q, k, v, *rel, key_mask, seed, rate, self.window_size)
        else:
            out = rel_attention.relative_self_attention(
                q, k, v, self.emb_rel_k, self.emb_rel_v, key_mask, self.window_size)
        return self.conv_o(out.transpose(1, 2).reshape(B, T, C))


class FFN(nn.Module):
    """Masked conv → relu → conv with SAME padding ((k−1)//2 left, k//2 right)."""

    def __init__(self, channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        pads = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size, padding=pads)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pads)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.drop(F.relu(self.conv_1(x * x_mask)))
        return self.conv_2(y * x_mask) * x_mask


class Encoder(nn.Module):
    """Post-norm encoder: x = LN(x + Attn(x)); x = LN(x + FFN(x))."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        h = hidden_channels
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(h, h, n_heads, window_size, p_dropout=p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(h) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(h, h, filter_channels, kernel_size, p_dropout) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(h) for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, generator=None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1] → [B, T, C]."""
        key_mask = x_mask[..., 0]
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = norm1(x + self.drop(attn(x, key_mask, generator)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
