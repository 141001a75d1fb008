"""Non-causal WaveNet stack ``WN`` (``vispeech_tpu/ops/wavenet.py``), the
dilation-1 form every WN of this model uses.

L layers of [weight-norm k-tap conv C → 2C, + speaker cond, tanh·sigmoid
gate (``fused_gate``, beside kernel B's plain version), 1×1 res/skip]; the
mask applies to x after every residual update and to the skip sum at the
end.  The layers' weights are packed as the JAX package's ``_fused`` packs
them.  When autograd needs gradients the whole stack runs through kernel
E's wrapper (``ops/kernels/wn_stack_train.py``, forward and backward),
otherwise through kernel B's (``ops/kernels/wn_stack.py``): each the kernel
on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vispeech_tpu_torch.ops.kernels import wn_stack, wn_stack_train
from vispeech_tpu_torch.ops.layers import WNConv1d


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        if dilation_rate != 1:
            raise ValueError(f"WN takes dilation_rate 1 only, got {dilation_rate}")
        C = hidden_channels
        self.hidden_channels = C
        self.kernel_size = kernel_size
        self.n_layers = n_layers
        self.cond_layer = WNConv1d(gin_channels, 2 * C * n_layers, 1) if gin_channels else None
        self.in_layers = nn.ModuleList(
            WNConv1d(C, 2 * C, kernel_size) for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            WNConv1d(C, 2 * C if i < n_layers - 1 else C, 1) for i in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1], g [B, 1, G] → [B, T, C]."""
        packed = self.packed(x.shape[0], g)
        if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in packed)):
            return wn_stack_train.wn_stack_train(x, x_mask, *packed, self.kernel_size)
        return wn_stack.wn_stack(x, x_mask, *packed, self.kernel_size)

    def packed(self, batch: int, g: Optional[torch.Tensor]):
        """Kernel B's operands: (cond [B, L, 2C] = input bias + speaker,
        w_in [L, k, C, 2C], w_rs [L, C, 2C], b_rs [L, 1, 2C]); the last
        layer's C res/skip outputs come first in its row, zeros after."""
        C, L = self.hidden_channels, self.n_layers
        w_in = torch.stack([conv.weight.permute(2, 1, 0) for conv in self.in_layers])
        b_in = torch.stack([conv.bias.float() for conv in self.in_layers])
        w_rs, b_rs = [], []
        for conv in self.res_skip_layers:
            w = conv.weight[:, :, 0].t()
            b = conv.bias.float()
            if w.shape[1] == C:
                w = torch.cat([w, torch.zeros_like(w)], dim=1)
                b = torch.cat([b, torch.zeros_like(b)])
            w_rs.append(w)
            b_rs.append(b)
        cond = b_in[None].expand(batch, L, 2 * C)
        if g is not None and self.cond_layer is not None:
            cond = cond + self.cond_layer(g.float()).reshape(batch, L, 2 * C)
        return cond, w_in, torch.stack(w_rs), torch.stack(b_rs)[:, None, :]
