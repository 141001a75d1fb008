"""The Synthesizer, inference half (``vispeech_tpu/models/synthesizer.py``).

TextEncoder → duration, pitch and energy heads (with the override
contract) → length regulator → FramePriorNet → Projection → z_p, then the
4 mean-only couplings in reverse → HiFi-GAN generator → tanh.  Parameter
names follow the reference ``SynthesizerTrn`` state dict.  The public
methods take and return the JAX package's [B, T, C] layout.

Override contract: a tensor control of rank ≥ 1 replaces the prediction; a
scalar (or None = 1.0) multiplies it.  Reference quirk kept: LF0 uses 2595
forward and 2590 in the inverse.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vispeech_tpu_torch.config import Config
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.models.predictors import (
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
)
from vispeech_tpu_torch.ops.attention import Encoder, MultiHeadAttention
from vispeech_tpu_torch.ops.flows import Flip, ResidualCouplingLayer
from vispeech_tpu_torch.ops.layers import (
    Conv1d,
    LayerNorm,
    WNConv1d,
    WNConvTranspose1d,
)
from vispeech_tpu_torch.ops.length_regulator import length_regulate
from vispeech_tpu_torch.ops.masking import length_mask
from vispeech_tpu_torch.ops.policy import FLOAT32, ServingPolicy
from vispeech_tpu_torch.ops.wavenet import WN


def f0_to_lf0(f0: torch.Tensor) -> torch.Tensor:
    return 2595.0 * torch.log10(1.0 + f0 / 700.0) / 500.0


def lf0_to_f0(lf0: torch.Tensor) -> torch.Tensor:
    return (torch.pow(10.0, lf0 * 500.0 / 2590.0) - 1.0) * 700.0


def normalize_energy(e: torch.Tensor) -> torch.Tensor:
    return (e - 60.0) / 36.0


def denormalize_energy(ne: torch.Tensor) -> torch.Tensor:
    return ne * 36.0 + 60.0


def _is_array(ctrl) -> bool:
    return isinstance(ctrl, torch.Tensor) and ctrl.ndim >= 1


def _scale(ctrl) -> float:
    return 1.0 if ctrl is None else float(ctrl)


class TextEncoder(nn.Module):
    """Phoneme embedding × √h → relative-attention encoder."""

    def __init__(self, n_vocab, hidden_channels, filter_channels, n_heads, n_layers,
                 kernel_size):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.symbol_emb = nn.Embedding(n_vocab, hidden_channels, _weight=torch.empty(
            n_vocab, hidden_channels))
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                               kernel_size)

    def forward(self, phonemes, lengths):
        x = self.symbol_emb(phonemes) * math.sqrt(self.hidden_channels)
        x_mask = length_mask(lengths, phonemes.shape[1], x.dtype)
        return self.encoder(x * x_mask, x_mask), x_mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram → posterior latent (16-layer WN).  Only its
    parameters are here, so that checkpoints load whole: voice conversion,
    which runs it, is a later slice of the port."""

    def __init__(self, in_channels, out_channels, hidden_channels, kernel_size=5,
                 dilation_rate=1, n_layers=16, gin_channels=0):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)


class ResidualCouplingBlock(nn.Module):
    """4 × (mean-only coupling, flip); reference names ``flows.{0,2,4,6}``.
    Inference runs it in reverse only."""

    def __init__(self, channels, hidden_channels, kernel_size=5, dilation_rate=1,
                 n_layers=4, n_flows=4, gin_channels=0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None):
        for flow in reversed(self.flows):
            x = flow(x, x_mask, g=g)
        return x


class FramePriorNet(nn.Module):
    def __init__(self, hidden_channels, filter_channels, n_heads, n_layers, kernel_size):
        super().__init__()
        self.fft_block = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                                 kernel_size)

    def forward(self, x_frame, x_mask):
        return self.fft_block(x_frame * x_mask, x_mask)


class Projection(nn.Module):
    def __init__(self, hidden_channels, out_channels):
        super().__init__()
        self.out_channels = out_channels
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x, x_mask):
        stats = self.proj(x) * x_mask
        return stats[..., :self.out_channels], stats[..., self.out_channels:]


class Synthesizer(nn.Module):
    """Inference network; ``policy`` fixes the decode dtype."""

    def __init__(self, n_vocab: int, spec_channels: int, inter_channels: int = 192,
                 hidden_channels: int = 192, filter_channels: int = 768, n_heads: int = 2,
                 n_layers: int = 4, kernel_size: int = 3, resblock: str = "1",
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3,
                 upsample_rates=(8, 8, 4, 2), upsample_initial_channel: int = 512,
                 upsample_kernel_sizes=(16, 16, 4, 4), n_speakers: int = 0,
                 gin_channels: int = 0, use_sdp: bool = False,
                 policy: ServingPolicy = FLOAT32):
        super().__init__()
        if use_sdp:
            raise NotImplementedError(
                "the stochastic duration predictor is not ported yet (use_sdp=false)")
        self.policy = policy
        self.n_speakers = n_speakers
        h, f = hidden_channels, filter_channels
        self.enc_p = TextEncoder(n_vocab, h, f, n_heads, n_layers, kernel_size)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, h, 5, 1, 16,
                                      gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, h, 5, 1, 4,
                                          gin_channels=gin_channels)
        self.duration_predictor = DurationPredictor(h, 256, 3, gin_channels=gin_channels)
        self.frame_prior_net = FramePriorNet(h, f, n_heads, n_layers, kernel_size)
        self.pitch_predictor = PitchPredictor(h, f, n_heads, kernel_size,
                                              gin_channels=gin_channels)
        self.energy_predictor = EnergyPredictor(h, gin_channels=gin_channels)
        self.project = Projection(h, inter_channels)
        self.pitch_prenet = Conv1d(1, h, 3, padding=1)
        self.energy_prenet = Conv1d(1, h, 3, padding=1)
        if n_speakers > 1:
            self.emb_g = nn.Embedding(n_speakers, gin_channels, _weight=torch.empty(
                n_speakers, gin_channels))

    @classmethod
    def from_config(cls, cfg: Config, n_vocab: int,
                    policy: ServingPolicy = FLOAT32) -> "Synthesizer":
        m = cfg.model
        return cls(
            n_vocab=n_vocab, spec_channels=cfg.data.spec_channels,
            inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
            filter_channels=m.filter_channels, n_heads=m.n_heads, n_layers=m.n_layers,
            kernel_size=m.kernel_size, resblock=m.resblock,
            resblock_kernel_sizes=m.resblock_kernel_sizes,
            resblock_dilation_sizes=m.resblock_dilation_sizes,
            upsample_rates=m.upsample_rates,
            upsample_initial_channel=m.upsample_initial_channel,
            upsample_kernel_sizes=m.upsample_kernel_sizes,
            n_speakers=cfg.data.n_speakers, gin_channels=m.gin_channels,
            use_sdp=m.use_sdp, policy=policy)

    def _speaker(self, sid):
        if self.n_speakers > 1 and sid is not None:
            return self.emb_g(sid)[:, None, :]
        return None

    @torch.no_grad()
    def infer(self, phonemes, phoneme_lengths, t_frames: int, sid=None,
              noise_scale: float = 1.0, max_len: Optional[int] = None,
              energy_control=None, pitch_control=None, duration_control=None,
              eps: Optional[torch.Tensor] = None, generator=None):
        """→ (audio [B, T·hop, 1], frame_mask, (z, z_p, m_p, logs_p), duration,
        f0, energy)."""
        z_p, frame_mask, duration, f0, energy, (m_p, logs_p) = self.infer_prior(
            phonemes, phoneme_lengths, t_frames, sid=sid, noise_scale=noise_scale,
            energy_control=energy_control, pitch_control=pitch_control,
            duration_control=duration_control, eps=eps, generator=generator)
        o, z, frame_mask = self.infer_decode(z_p, frame_mask, sid=sid, max_len=max_len)
        return o, frame_mask, (z, z_p, m_p, logs_p), duration, f0, energy

    @torch.no_grad()
    def infer_prior(self, phonemes, phoneme_lengths, t_frames: int, sid=None,
                    noise_scale: float = 1.0, energy_control=None, pitch_control=None,
                    duration_control=None, eps: Optional[torch.Tensor] = None,
                    generator=None):
        """Text → z_p = m_p + eps·exp(logs_p)·noise_scale over a static
        ``t_frames`` budget.  ``eps`` [B, T, inter] injects the prior noise;
        None draws it from ``generator``.
        → (z_p, frame_mask, duration, f0 [Hz], energy, (m_p, logs_p))."""
        g = self._speaker(sid)
        x, x_mask = self.enc_p(phonemes, phoneme_lengths)

        if _is_array(duration_control):
            duration = duration_control.to(x.dtype)
        else:
            logw = self.duration_predictor(x, x_mask, g=g)
            w = (torch.exp(logw) * x_mask - 1.0) * _scale(duration_control)
            duration = torch.ceil(w)[..., 0]

        if _is_array(pitch_control):
            lf0 = f0_to_lf0(pitch_control.to(x.dtype))
        else:
            lf0 = self.pitch_predictor(x, x_mask, g=g) * _scale(pitch_control)
        x = x + self.pitch_prenet(lf0[..., None])
        f0 = lf0_to_f0(lf0)

        if _is_array(energy_control):
            norm_energy = normalize_energy(energy_control.to(x.dtype))
        else:
            pred = self.energy_predictor(x, g=g)
            norm_energy = normalize_energy(denormalize_energy(pred)
                                           * _scale(energy_control))
        x = x + self.energy_prenet(norm_energy[..., None])
        energy = denormalize_energy(norm_energy)

        x_frame, frame_lengths = length_regulate(x, duration, t_frames)
        frame_mask = length_mask(frame_lengths, t_frames, x.dtype)
        x_frame = self.frame_prior_net(x_frame, frame_mask)
        m_p, logs_p = self.project(x_frame, frame_mask)
        if eps is None:
            eps = torch.randn(m_p.shape, generator=generator, device=m_p.device,
                              dtype=m_p.dtype)
        z_p = m_p + eps * torch.exp(logs_p) * noise_scale
        return z_p, frame_mask, duration, f0, energy, (m_p, logs_p)

    @torch.no_grad()
    def infer_decode(self, z_p, frame_mask, sid=None, max_len: Optional[int] = None):
        """Flow reverse → vocoder in the policy's decode dtype.
        → (audio [B, T·hop, 1] f32, z, frame_mask)."""
        g = self._speaker(sid)
        z = self.flow(z_p, frame_mask, g=g) * frame_mask
        if max_len is not None:
            z, frame_mask = z[:, :max_len], frame_mask[:, :max_len]
        dtype = self.policy.torch_decode_dtype
        o = self.dec(z.to(dtype), g=None if g is None else g.to(dtype))
        return o.float(), z, frame_mask

    @torch.no_grad()
    def predict_durations(self, phonemes, phoneme_lengths, sid=None):
        """Duration-only pass → frame counts [B, N] (≥ 0)."""
        g = self._speaker(sid)
        x, x_mask = self.enc_p(phonemes, phoneme_lengths)
        logw = self.duration_predictor(x, x_mask, g=g)
        w = torch.exp(logw) * x_mask - 1.0
        return torch.clamp(torch.ceil(w), min=0.0)[..., 0]


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``torch.Generator(seed)`` on the CPU, so the
    same seed gives the same weights on any device: convs and linears
    U(±1/√fan_in) (the decoder's weight-normed convs N(0, 0.01)), weight-norm
    gains = ‖v‖, embeddings and relative tables normal, norms 1 / 0."""
    gen = torch.Generator().manual_seed(seed)

    def fill(p, values):
        p.copy_(values.to(p.device, p.dtype))

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    for name, mod in model.named_modules():
        if isinstance(mod, (WNConv1d, WNConvTranspose1d)):
            v = mod.weight_v
            if name.startswith("dec."):
                fill(v, torch.randn(v.shape, generator=gen) * 0.01)
            else:
                fill(v, uniform(v.shape, v[0].numel()))
            fill(mod.weight_g, v.float().pow(2).sum(dim=(1, 2), keepdim=True).sqrt())
            fill(mod.bias, uniform(mod.bias.shape, v[0].numel()))
        elif isinstance(mod, (Conv1d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            fill(mod.weight, uniform(mod.weight.shape, fan_in))
            if mod.bias is not None:
                fill(mod.bias, uniform(mod.bias.shape, fan_in))
        elif isinstance(mod, nn.Embedding):
            std = mod.embedding_dim ** -0.5 if name.endswith("symbol_emb") else 1.0
            fill(mod.weight, torch.randn(mod.weight.shape, generator=gen) * std)
        elif isinstance(mod, MultiHeadAttention):
            d = mod.emb_rel_k.shape[-1]
            for p in (mod.emb_rel_k, mod.emb_rel_v):
                fill(p, torch.randn(p.shape, generator=gen) * d ** -0.5)
        elif isinstance(mod, LayerNorm):
            mod.gamma.fill_(1.0)
            mod.beta.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
