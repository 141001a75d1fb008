"""Non-causal WaveNet stack ``WN`` (``vispeech_tpu/ops/wavenet.py``), the
dilation-1 form every WN of this model uses.

L layers of [weight-norm k-tap conv C → 2C, + speaker cond, tanh·sigmoid
gate (``fused_gate``, beside kernel B's plain version), 1×1 res/skip]; the
mask applies to x after every residual update and to the skip sum at the
end.  The layers' weights are packed as the JAX package's ``_fused`` packs
them.  When autograd needs gradients the whole stack runs through kernel
E's wrapper (``ops/kernels/wn_stack_train.py``, forward and backward), or,
with ``fused_train`` off (``train.fused_wn: false``), through E's plain
version under autograd on a CPU tensor (on a CUDA tensor E is the only
training route, and the switch off raises); otherwise through kernel B's
(``ops/kernels/wn_stack.py``): each the kernel on a CUDA tensor, its plain
version on a CPU tensor.  On the card with autograd off, B's prepared
weights come from ``kernel_operands``, kept while the frozen weights stay
the same; on the CPU, or whenever autograd is on, nothing is kept.
Sharded on the model axis (``parallel/sharding.py``), the input convs hold
slices of their ``weight_v``: ``packed`` reads each conv's ``weight``,
which gathers it whole, and the gather's backward hands kernel E's dW_in
back as the rank's slice.
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
        self._kernel_cache = None   # kernel_operands' (key, tensors, operands)
        self.fused_train = True       # train.fused_wn: kernel E under autograd

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C], x_mask [B, T, 1], g [B, 1, G] → [B, T, C]."""
        if x.device.type != "cpu" and not torch.is_grad_enabled():
            b_in, prepared, b_rs = self.kernel_operands()
            return wn_stack.wn_stack(x, x_mask, self._cond(b_in, x.shape[0], g), None, None,
                                     b_rs, self.kernel_size, prepared)
        packed = self.packed(x.shape[0], g)
        if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in packed)):
            if self.fused_train:
                return wn_stack_train.wn_stack_train(x, x_mask, *packed, self.kernel_size)
            if _on_card(x):
                raise RuntimeError(
                    "train.fused_wn is false, but kernel E is the port's only WN training "
                    "path on the card: set train.fused_wn true (E's plain version runs on "
                    "CPU tensors only)")
            # E's plain forward, differentiated by autograd, its operands
            # rounded to bf16 where x is bf16 as the kernel rounds them
            args = [t.float() for t in (x, x_mask, *packed)]
            out, _ = wn_stack_train.wn_stack_train_plain_fwd(
                *args, self.kernel_size, x.dtype == torch.bfloat16)
            return out.to(x.dtype)
        return wn_stack.wn_stack(x, x_mask, *packed, self.kernel_size)

    def _cond(self, b_in: torch.Tensor, batch: int, g: Optional[torch.Tensor]):
        """cond [B, L, 2C]: the input convs' bias b_in [L, 2C] + speaker."""
        cond = b_in[None].expand(batch, *b_in.shape)
        if g is not None and self.cond_layer is not None:
            cond = cond + self.cond_layer(g.float()).reshape(cond.shape)
        return cond

    def packed(self, batch: int, g: Optional[torch.Tensor]):
        """Kernel B's operands: (cond [B, L, 2C] = input bias + speaker,
        w_in [L, k, C, 2C], w_rs [L, C, 2C], b_rs [L, 1, 2C]); the last
        layer's C res/skip outputs come first in its row, zeros after."""
        C = self.hidden_channels
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
        return self._cond(b_in, batch, g), w_in, torch.stack(w_rs), torch.stack(b_rs)[:, None, :]

    def kernel_operands(self):
        """Kernel B's operands that do not depend on the request: (b_in
        [L, 2C], ``wn_stack.prepare_weights``' split and laid-out W_in and
        W_rs, b_rs [L, 1, 2C]).  With frozen weight norms
        (``freeze_weight_norm``, as serving does) they are kept while those
        frozen tensors stay the same and unchanged in place; otherwise they
        are built at each call."""
        convs = [*self.in_layers, *self.res_skip_layers]
        frozen = all(c.folded is not None for c in convs)
        if frozen:
            tensors = [t for c in convs for t in (c.folded, c.bias)]
            key = tuple((id(t), t._version) for t in tensors)
            if self._kernel_cache is not None and self._kernel_cache[0] == key:
                return self._kernel_cache[2]
        with torch.no_grad():
            cond, w_in, w_rs, b_rs = self.packed(1, None)
            operands = (cond[0], wn_stack.prepare_weights(w_in, w_rs), b_rs)
        if frozen:
            # the tensors stay referenced, so their ids cannot be reused
            self._kernel_cache = (key, tensors, operands)
        return operands


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` would launch the kernels."""
    return x.device.type != "cpu"
