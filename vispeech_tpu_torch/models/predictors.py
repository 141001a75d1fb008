"""Prosody heads (``vispeech_tpu/models/predictors.py``): duration
(deterministic, and the stochastic flow-based one), pitch (6-layer
relative-attention encoder) and energy (FastSpeech2 variance stack).
Layout [B, T, C].

Training follows the reference: dropout 0.5 after each layer norm of the
duration and variance stacks (``nn.Dropout``, off in eval mode); the
duration and pitch heads see their input and speaker embedding detached,
the energy head only its speaker embedding (``predictors.py:47-49,
111-114, 203-205, 259`` of the JAX package)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vispeech_tpu_torch.ops.attention import Encoder
from vispeech_tpu_torch.ops.ddsconv import DDSConv
from vispeech_tpu_torch.ops.flows import ConvFlow, ElementwiseAffine, Flip, Log
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


def _flow_stack(channels: int, kernel_size: int, n_flows: int) -> nn.ModuleList:
    """[ElementwiseAffine(2)] + n_flows × [ConvFlow, Flip], the reference's
    ``flows`` / ``post_flows`` lists."""
    flows = nn.ModuleList([ElementwiseAffine(2)])
    for _ in range(n_flows):
        flows.append(ConvFlow(2, channels, kernel_size, n_layers=3))
        flows.append(Flip())
    return flows


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model: the NLL of durations (``reverse=False``)
    and sampling of logw (``reverse=True``), with the reference's names:
    ``flows`` (the affine at 0, ConvFlows at odd and Flips at even indices
    from 2), ``post_*`` (the posterior over the dequantisation noise, used
    by the NLL only), ``pre`` / ``convs`` / ``proj`` / ``cond`` (the text
    conditioning).

    Reference quirks kept: ``filter_channels`` is overridden by
    ``in_channels``; sampling skips the first ConvFlow.  ``x`` and ``g`` are
    detached.  Noise is injected (``noise``) or drawn from the caller's
    ``generator``, never from the global stream.

    ``unloaded`` names the parameters a weight load left empty (see
    ``utils/jax_weights.py``): a direction that needs one of them raises.
    """

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        fc = in_channels   # the reference's override of filter_channels
        self.log_flow = Log()
        self.flows = _flow_stack(fc, kernel_size, n_flows)
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.post_flows = _flow_stack(fc, kernel_size, 4)
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.cond = Conv1d(gin_channels, fc, 1) if gin_channels else None
        self.unloaded: Sequence[str] = ()

    def reverse_path(self):
        """The parameter names that sampling reads (not ``flows.1`` and no
        ``post_*``)."""
        return [n for n, _ in self.named_parameters()
                if not n.startswith(("post_", "flows.1."))]

    def _require(self, reverse: bool) -> None:
        if not self.unloaded:
            return
        names = self.reverse_path() if reverse else [n for n, _ in self.named_parameters()]
        what = "sampling" if reverse else "NLL"
        missing = sorted(set(self.unloaded) & set(names))
        if missing:
            raise ValueError(
                f"the stochastic duration predictor's {what} needs parameters that were "
                f"not loaded: {['sdp.' + n for n in missing[:8]]} ({len(missing)} in all); "
                "a tree trained by the JAX package holds no 'sdp' subtree")

    def forward(self, x, x_mask, w=None, g=None, reverse: bool = False,
                noise_scale: float = 1.0, noise=None, generator=None):
        """x [B, N, in], x_mask [B, N, 1], g [B, 1, gin].  Forward: w [B, N, 1]
        durations → NLL + log q [B]; ``noise`` [B, N, 2] is the posterior's
        e_q (unmasked).  Reverse: → logw [B, N, 1]; ``noise`` [B, N, 2] is the
        prior sample before ``noise_scale``."""
        self._require(reverse)
        x = self.pre(x.detach())
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        x = self.proj(self.convs(x, x_mask)) * x_mask
        B, N, _ = x.shape
        if noise is None:
            noise = torch.randn((B, N, 2), generator=generator, device=x.device,
                                dtype=x.dtype)
        noise = noise.to(x.dtype)

        if reverse:
            # undo the flows in reverse order, skipping flows[1] (the first
            # ConvFlow) as the reference does
            z = noise * noise_scale
            for flow in list(reversed(self.flows))[:-2]:
                z = flow(z, x_mask, g=x, reverse=True)
            z = self.flows[0](z, x_mask, g=x, reverse=True)
            return z[..., :1]

        h_w = self.post_proj(self.post_convs(self.post_pre(w), x_mask)) * x_mask
        e_q = noise * x_mask
        cond_q = x + h_w
        z_q, logdet_q = self._run(self.post_flows, e_q, x_mask, cond_q)
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_q = logdet_q + torch.sum((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask,
                                        dim=(1, 2))
        logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_q

        z0, logdet = self.log_flow(z0, x_mask)
        z, logdet_flows = self._run(self.flows, torch.cat([z0, z1], dim=-1), x_mask, x)
        nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2)) \
            - (logdet + logdet_flows)
        return nll + logq

    @staticmethod
    def _run(flows, z, x_mask, g):
        """The flows forward → (z, summed log-det [B]); a Flip's is 0."""
        logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for flow in flows:
            if isinstance(flow, Flip):
                z = flow(z)
            else:
                z, ld = flow(z, x_mask, g=g)
                logdet = logdet + ld
        return z, logdet


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
