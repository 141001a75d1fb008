"""Relative-position multi-head attention, the conv FFN, the post-norm
encoder, and the causal ``Decoder`` and ``FFT`` stacks
(``vispeech_tpu/ops/attention.py``).

When autograd needs gradients attention runs through kernel F's wrapper
(``ops/kernels/rel_attention_train.py``: forward and backward, dropout on
the probabilities at ``p_dropout`` in training mode), or, with
``fused_train`` off (``train.fused_attn: false``), through F's plain
forward under autograd on a CPU tensor, with the same hashed keep mask
(the JAX package draws that dropout from flax's stream, which no torch
stream can match); on a CUDA tensor F is the only training route, and the
switch off raises.  Otherwise attention runs through kernel A's wrapper
(``ops/kernels/rel_attention.py``).  Each wrapper launches its kernel on a
CUDA tensor and runs its plain version on a CPU tensor.  Both mask key
positions only; the encoder re-masks every layer's output, so valid rows
match the JAX package's outer-product mask exactly.  The other dropout
sites are ``nn.Dropout``: the FFN's activations and the encoder's
attention and FFN outputs.  A dropout seed for F comes from the caller's CPU ``generator``.

The variants the encoder does not use (a source ``c`` for cross-attention,
no relative tables, ``proximal_bias``, ``block_length``, a 4-D
``attn_mask``) run plain PyTorch, as the JAX package sends them to XLA and
never to its kernels: scores masked with −1e4 where ``attn_mask`` is 0, the
softmax in f32, dropout on the probabilities by ``nn.Dropout``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.kernels import rel_attention, rel_attention_train
from vispeech_tpu_torch.ops.layers import Conv1d, LayerNorm


class MultiHeadAttention(nn.Module):
    """Attention with shared (``heads_share``) window-w relative key/value
    tables ``emb_rel_k`` / ``emb_rel_v`` [n_rel, 2w+1, d], or none
    (``window_size`` None)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = 4, heads_share: bool = True,
                 p_dropout: float = 0.0, proximal_bias: bool = False,
                 block_length: Optional[int] = None):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.window_size = window_size
        self.proximal_bias = proximal_bias
        self.block_length = block_length
        d = channels // n_heads
        n_rel = 1 if heads_share else n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is None:
            self.register_parameter("emb_rel_k", None)
            self.register_parameter("emb_rel_v", None)
        else:
            self.emb_rel_k = nn.Parameter(torch.empty(n_rel, 2 * window_size + 1, d))
            self.emb_rel_v = nn.Parameter(torch.empty(n_rel, 2 * window_size + 1, d))
        self.drop = nn.Dropout(p_dropout)
        self.fused_train = True   # train.fused_attn: kernel F under autograd

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                generator=None, c: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C] attending to ``c`` [B, T_s, C] (None: x) → [B, T, out].
        The encoder's route (self-attention with relative tables, masked by
        ``key_mask`` [B, T] alone) runs kernel A or F; any other runs
        ``_attend``, masked by ``attn_mask`` [B, 1, T, T_s] (0: masked)."""
        if (c is not None or attn_mask is not None or self.window_size is None
                or self.proximal_bias or self.block_length is not None):
            return self._attend(x, x if c is None else c, attn_mask)
        B, T, C = x.shape

        def heads(t):
            return t.reshape(B, T, self.n_heads, C // self.n_heads).transpose(1, 2)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        rel = (self.emb_rel_k.to(q.dtype), self.emb_rel_v.to(q.dtype))
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v) + rel):
            rate = self.p_dropout if self.training else 0.0
            seed = rel_attention_train.draw_seed(generator) if rate > 0.0 else 0
            if self.fused_train:
                out = rel_attention_train.relative_self_attention_train(
                    q, k, v, *rel, key_mask, seed, rate, self.window_size)
            elif _on_card(q):
                raise RuntimeError(
                    "train.fused_attn is false, but kernel F is the port's only attention "
                    "training path on the card: set train.fused_attn true (F's plain "
                    "version runs on CPU tensors only)")
            else:
                args = [t.float() for t in (q, k, v, *rel, key_mask)]
                out, _ = rel_attention_train.relative_self_attention_train_plain_fwd(
                    *args, seed, rate, self.window_size, q.dtype == torch.bfloat16)
                out = out.to(q.dtype)
        else:
            out = rel_attention.relative_self_attention(
                q, k, v, self.emb_rel_k, self.emb_rel_v, key_mask, self.window_size)
        return self.conv_o(out.transpose(1, 2).reshape(B, T, C))

    def _attend(self, x, c, attn_mask):
        """The JAX package's unfused attention in plain PyTorch."""
        B, T_t, C = x.shape
        T_s = c.shape[1]
        H, d = self.n_heads, C // self.n_heads
        q = self.conv_q(x).reshape(B, T_t, H, d).transpose(1, 2) * (1.0 / math.sqrt(d))
        k = self.conv_k(c).reshape(B, T_s, H, d).transpose(1, 2)
        v = self.conv_v(c).reshape(B, T_s, H, d).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2))
        if self.window_size is not None:
            if T_s != T_t:
                raise ValueError("relative attention requires self-attention")
            rk = _pad_rel_embeddings(self.emb_rel_k, T_t, self.window_size)
            rel_logits = torch.einsum("bhtd,hmd->bhtm", q,
                                      rk.to(q.dtype).expand(H, -1, -1))
            scores = scores + _relative_to_absolute(rel_logits)
        if self.proximal_bias:
            r = torch.arange(T_s, dtype=torch.float32, device=x.device)
            scores = scores - torch.log1p(torch.abs(r[None, :] - r[:, None])).to(scores.dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
            if self.block_length is not None:
                t = torch.arange(T_s, device=x.device)
                band = torch.abs(t[None, :] - t[:, None]) <= self.block_length
                scores = scores.masked_fill(~band, -1e4)
        p = self.drop(torch.softmax(scores.float(), dim=-1).to(scores.dtype))
        out = torch.matmul(p, v)
        if self.window_size is not None:
            rv = _pad_rel_embeddings(self.emb_rel_v, T_t, self.window_size)
            out = out + torch.einsum("bhtm,hmd->bhtd", _absolute_to_relative(p),
                                     rv.to(out.dtype).expand(H, -1, -1))
        return self.conv_o(out.transpose(1, 2).reshape(B, T_t, C))


def _pad_rel_embeddings(rel: torch.Tensor, length: int, window_size: int) -> torch.Tensor:
    """The [n_rel, 2w+1, d] tables sliced or padded to [n_rel, 2L−1, d]."""
    pad = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad > 0:
        rel = F.pad(rel, (0, 0, pad, pad))
    return rel[:, start:start + 2 * length - 1]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L−1] → [B, H, L, L] by the pad-reshape skew."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] → [B, H, L, 2L−1]."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


class FFN(nn.Module):
    """Masked conv → relu (or ``activation="gelu"``: y·σ(1.702y)) → conv,
    SAME padding ((k−1)//2 left, k//2 right) or ``causal`` (k−1 left)."""

    def __init__(self, channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 activation: Optional[str] = None, causal: bool = False):
        super().__init__()
        pads = (kernel_size - 1, 0) if causal else ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size, padding=pads)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pads)
        self.drop = nn.Dropout(p_dropout)
        self.gelu = activation == "gelu"

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.conv_1(x * x_mask)
        y = self.drop(y * torch.sigmoid(1.702 * y) if self.gelu else F.relu(y))
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


def _causal_mask(x_mask: torch.Tensor) -> torch.Tensor:
    """x_mask [B, T, 1] → its outer product [B, 1, T, T] kept on and below
    the diagonal."""
    m = x_mask[..., 0]
    T = m.shape[1]
    causal = torch.tril(torch.ones(T, T, dtype=m.dtype, device=m.device))
    return m[:, None, :, None] * m[:, None, None, :] * causal


class Decoder(nn.Module):
    """Post-norm causal decoder: proximal-biased causal self-attention,
    cross-attention over encoder states ``h``, causal conv FFN; the
    reference's names (``self_attn_layers``, ``encdec_attn_layers``,
    ``norm_layers_{0,1,2}``, ``ffn_layers``)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 proximal_bias: bool = True):
        super().__init__()
        h, n = hidden_channels, range(n_layers)
        self.self_attn_layers = nn.ModuleList(
            MultiHeadAttention(h, h, n_heads, None, p_dropout=p_dropout,
                               proximal_bias=proximal_bias) for _ in n)
        self.norm_layers_0 = nn.ModuleList(LayerNorm(h) for _ in n)
        self.encdec_attn_layers = nn.ModuleList(
            MultiHeadAttention(h, h, n_heads, None, p_dropout=p_dropout) for _ in n)
        self.norm_layers_1 = nn.ModuleList(LayerNorm(h) for _ in n)
        self.ffn_layers = nn.ModuleList(
            FFN(h, h, filter_channels, kernel_size, p_dropout, causal=True) for _ in n)
        self.norm_layers_2 = nn.ModuleList(LayerNorm(h) for _ in n)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask, h, h_mask):
        """x [B, T_t, C], x_mask [B, T_t, 1], h [B, T_s, C], h_mask [B, T_s, 1]
        → [B, T_t, C]."""
        self_mask = _causal_mask(x_mask)
        cross_mask = x_mask[:, None, :, 0, None] * h_mask[:, None, None, :, 0]
        x = x * x_mask
        for attn, norm0, cross, norm1, ffn, norm2 in zip(
                self.self_attn_layers, self.norm_layers_0, self.encdec_attn_layers,
                self.norm_layers_1, self.ffn_layers, self.norm_layers_2):
            x = norm0(x + self.drop(attn(x, attn_mask=self_mask)))
            x = norm1(x + self.drop(cross(x, c=h, attn_mask=cross_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class FFT(nn.Module):
    """Post-norm causal self-attention + causal conv FFN stack; the
    reference's names (``self_attn_layers``, ``norm_layers_{0,1}``,
    ``ffn_layers``)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 proximal_bias: bool = False):
        super().__init__()
        h, n = hidden_channels, range(n_layers)
        self.self_attn_layers = nn.ModuleList(
            MultiHeadAttention(h, h, n_heads, None, p_dropout=p_dropout,
                               proximal_bias=proximal_bias) for _ in n)
        self.norm_layers_0 = nn.ModuleList(LayerNorm(h) for _ in n)
        self.ffn_layers = nn.ModuleList(
            FFN(h, h, filter_channels, kernel_size, p_dropout, causal=True) for _ in n)
        self.norm_layers_1 = nn.ModuleList(LayerNorm(h) for _ in n)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask):
        """x [B, T, C], x_mask [B, T, 1] → [B, T, C]."""
        attn_mask = _causal_mask(x_mask)
        x = x * x_mask
        for attn, norm0, ffn, norm1 in zip(self.self_attn_layers, self.norm_layers_0,
                                           self.ffn_layers, self.norm_layers_1):
            x = norm0(x + self.drop(attn(x, attn_mask=attn_mask)))
            x = norm1(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` would launch the kernels."""
    return x.device.type != "cpu"
