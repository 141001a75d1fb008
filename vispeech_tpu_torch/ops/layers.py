"""Primitive layers with the reference state-dict layout.

Modules take [B, T, C] like the JAX package (``vispeech_tpu/ops/layers.py``);
``forward_cf`` takes channel-first [B, C, T] for the decoder, which stays
channel-first inside.  Weights keep torch's layout: conv [cout, cin, k],
transposed conv [cin, cout, k], and weight norm as its own ``weight_g`` /
``weight_v`` parameters (w = g·v/‖v‖, ‖·‖ with ε = 1e-12 inside the square
root, as in the JAX package).  Weights are cast to the activation dtype at
each call; the weight norm is computed in f32 (in f64 for f64 weights),
at each call or once by ``freeze_weight_norm`` for a model whose weights
no longer change.

Sharded on the model axis (``parallel/sharding.py`` sets ``tp``, a
``parallel.tensor.ModelShard``, and keeps the rank's slice of the weight's
output channels): a column-parallel conv (``tp.column``) computes its own
output channels from its input (``tp.copy``) and all-gathers them, its
whole ``weight_g`` and ``bias`` read through the rank's slice; a
``WNConv1d`` whose ``tp`` is not column-parallel gathers ``weight_v`` and
computes every channel.  ``weight`` is always the whole effective weight
(gathered), which the kernels' packers read.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[None, int, Tuple[int, int]]


def _empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def _pads(kernel_size: int, dilation: int, padding: Padding) -> Tuple[int, int]:
    if padding is None:
        p = (kernel_size * dilation - dilation) // 2
        return p, p
    if isinstance(padding, int):
        return padding, padding
    return tuple(padding)


def _conv_cf(x, weight, bias, pads, dilation, stride=1, groups=1):
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if pads[0] == pads[1]:
        return F.conv1d(x, weight, bias, stride, pads[0], dilation, groups)
    return F.conv1d(F.pad(x, pads), weight, bias, stride, 0, dilation, groups)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in f64 when it is f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _weight_norm(v: torch.Tensor, g: torch.Tensor, dims, squares=None) -> torch.Tensor:
    """g·v/‖v‖ with ‖v‖² summed over ``dims``, or given as ``squares``."""
    vf = at_least_f32(v)
    sq = torch.sum(vf * vf, dim=dims, keepdim=True) if squares is None else squares
    return vf * (at_least_f32(g) / torch.sqrt(sq + 1e-12))


class Conv1d(nn.Module):
    """1-D convolution; padding None = symmetric (k·d − d)//2, or an int, or
    (left, right); ``groups`` splits the channels (``groups`` = channels:
    depthwise)."""

    stride = 1
    tp = None   # parallel.tensor.ModelShard of a conv sharded on the model axis

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, dilation: int = 1,
                 padding: Padding = None, bias: bool = True, groups: int = 1):
        super().__init__()
        self.weight = _empty(cout, cin // groups, kernel_size)
        self.bias = _empty(cout) if bias else None
        self.dilation = dilation
        self.pads = _pads(kernel_size, dilation, padding)
        self.groups = groups

    def local_weight(self) -> torch.Tensor:
        """The effective weight of the output channels this rank computes
        (the weight itself: this rank's slice when sharded)."""
        return self.weight

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None or not tp.column:
            return _conv_cf(x, self.weight, self.bias, self.pads, self.dilation, self.stride,
                            self.groups)
        bias = None if self.bias is None else tp.own(self.bias, 0)
        y = _conv_cf(tp.copy(x), self.local_weight(), bias, self.pads, self.dilation,
                     self.stride, self.groups)
        return tp.gather(y, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None and self.weight.shape[-1] == 1 and self.stride == 1 \
                and self.groups == 1:
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.linear(x, self.weight[:, :, 0].to(x.dtype), bias)
        return self.forward_cf(x.transpose(1, 2)).transpose(1, 2)


class _WeightNormed:
    """w = g·v/‖v‖ over dims (1, 2) of ``weight_v``, or the folded copy.
    ``out_dim``: the dim of ``weight_v`` that holds the output channels."""

    folded = None
    tp = None
    out_dim = 0

    @property
    def weight(self) -> torch.Tensor:
        if self.folded is not None:
            return self.folded
        if self.tp is None:
            return _weight_norm(self.weight_v, self.weight_g, (1, 2))
        if not self.tp.column:
            return _weight_norm(self.tp.gather(self.weight_v, self.out_dim), self.weight_g,
                                (1, 2))
        return self.tp.gather(self.local_weight(), self.out_dim)

    def local_weight(self) -> torch.Tensor:
        """The effective weight of this rank's output channels (sharded)."""
        if self.folded is not None:
            return self.tp.own(self.folded, self.out_dim)
        return self._local_weight_norm()


def freeze_weight_norm(model: nn.Module) -> nn.Module:
    """Fold every weight norm of ``model`` once, on its current device, so a
    serving model does not recompute it at every call.  Call it after the
    last weight load or device move."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _WeightNormed):
                m.folded = None
                m.folded = m.weight
    return model


class WNConv1d(_WeightNormed, Conv1d):
    """Weight-normalised Conv1d: ``weight_g`` [cout, 1, 1], ``weight_v``
    [cout, cin/groups, k], norm per output channel."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1, dilation: int = 1,
                 padding: Padding = None, bias: bool = True, stride: int = 1,
                 groups: int = 1):
        nn.Module.__init__(self)
        self.weight_g = _empty(cout, 1, 1)
        self.weight_v = _empty(cout, cin // groups, kernel_size)
        self.bias = _empty(cout) if bias else None
        self.dilation = dilation
        self.pads = _pads(kernel_size, dilation, padding)
        self.stride, self.groups = stride, groups

    def _local_weight_norm(self) -> torch.Tensor:
        # the norm is per output channel: a slice of the gains, no collective
        return _weight_norm(self.weight_v, self.tp.own(self.weight_g, 0), (1, 2))


class WNConvTranspose1d(_WeightNormed, nn.Module):
    """Weight-normalised ConvTranspose1d(k, stride=u, padding=(k−u)//2):
    output length T·u.  ``weight_v`` [cin, cout, k], norm per input channel."""

    out_dim = 1

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int):
        super().__init__()
        self.weight_g = _empty(cin, 1, 1)
        self.weight_v = _empty(cin, cout, kernel_size)
        self.bias = _empty(cout)
        self.stride = stride
        self.padding = (kernel_size - stride) // 2

    def _local_weight_norm(self) -> torch.Tensor:
        # ‖v‖² per input channel sums over output channels on every rank
        vf = at_least_f32(self.weight_v)
        sq = self.tp.all_reduce(torch.sum(vf * vf, dim=(1, 2), keepdim=True))
        return _weight_norm(vf, self.weight_g, (1, 2), sq)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return F.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                      stride=self.stride, padding=self.padding)
        y = F.conv_transpose1d(self.tp.copy(x), self.local_weight().to(x.dtype),
                               self.tp.own(self.bias, 0).to(x.dtype), stride=self.stride,
                               padding=self.padding)
        return self.tp.gather(y, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_cf(x.transpose(1, 2)).transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over channels (last axis), ε 1e-5, computed in f32;
    parameters ``gamma`` / ``beta`` as in the reference modules.LayerNorm."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.gamma.float(),
                         self.beta.float(), self.eps)
        return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """x ≥ 0 ? x : slope·x, as ``where(x >= 0, x, x·slope)`` in the JAX
    package (bit-identical) in one kernel instead of two."""
    return F.leaky_relu(x, slope)
