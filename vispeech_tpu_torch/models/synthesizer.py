"""The Synthesizer (``vispeech_tpu/models/synthesizer.py``).

Inference: TextEncoder → duration, pitch and energy heads (with the
override contract) → length regulator → FramePriorNet → Projection → z_p,
then the 4 mean-only couplings in reverse → HiFi-GAN generator → tanh.
With ``use_sdp`` the stochastic duration predictor (``sdp``) samples the
durations of ``infer`` / ``infer_prior`` under a scalar or no duration
control; ``predict_durations`` (so the engine), voice conversion and
training keep the deterministic head, as in the JAX package.
Voice conversion: the posterior encoder on a linear spectrogram, the
couplings forward under the source speaker and in reverse under the
target, then the same generator.
Training (``forward``): the same text side with teacher-forced duration,
pitch and energy and their losses, the posterior encoder on the linear
spectrogram, the couplings forward (z → z_p) and the generator on a random
segment of z.  ``bf16_stages`` names the stages whose compute runs in
bf16 (``_stage``: float inputs cast to bf16 at the boundary, float outputs
back to f32), as the JAX package's do; the decoder is stage ``dec_body``
(bf16 body, f32 conv_post and tanh) or ``dec``.  Parameter
names follow the reference ``SynthesizerTrn`` state dict.  The public
methods take and return the JAX package's [B, T, C] layout.

Override contract: a tensor control of rank ≥ 1 replaces the prediction; a
scalar (or None = 1.0) multiplies it.  Reference quirk kept: LF0 uses 2595
forward and 2590 in the inverse.
"""

from __future__ import annotations

import functools
import logging
import math
from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn

from vispeech_tpu_torch.config import Config
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.models.predictors import (
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
    StochasticDurationPredictor,
)
from vispeech_tpu_torch.ops.attention import Encoder, MultiHeadAttention
from vispeech_tpu_torch.ops.flows import ElementwiseAffine, Flip, ResidualCouplingLayer
from vispeech_tpu_torch.ops.layers import Conv1d, LayerNorm
from vispeech_tpu_torch.ops.length_regulator import length_regulate
from vispeech_tpu_torch.ops.masking import length_mask, rand_slice_segments
from vispeech_tpu_torch.ops.policy import FLOAT32, ServingPolicy
from vispeech_tpu_torch.ops.wavenet import WN
from vispeech_tpu_torch.utils import profiling


logger = logging.getLogger("vispeech_tpu_torch")


@functools.lru_cache(maxsize=None)
def _note_unfolded_decoder() -> None:
    """Say once a process that ``train.folded_mrf`` is not followed."""
    logger.warning(
        "train.folded_mrf is true, but the port's training decoder runs every MRF stage "
        "as the plain ResBlock1: on the H100 the folded stage's forward and backward took "
        "1.3-2.3x the plain stage's (PERF.md section 6, chip_smoke.py --fold)")


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
                 kernel_size, p_dropout: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.symbol_emb = nn.Embedding(n_vocab, hidden_channels, _weight=torch.empty(
            n_vocab, hidden_channels))
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                               kernel_size, p_dropout=p_dropout)

    def forward(self, phonemes, lengths, generator=None):
        x = self.symbol_emb(phonemes) * math.sqrt(self.hidden_channels)
        x_mask = length_mask(lengths, phonemes.shape[1], x.dtype)
        return self.encoder(x * x_mask, x_mask, generator), x_mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram → posterior latent z = (m + eps·e^logs)·mask
    through a 16-layer WN."""

    def __init__(self, in_channels, out_channels, hidden_channels, kernel_size=5,
                 dilation_rate=1, n_layers=16, gin_channels=0):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)
        self.out_channels = out_channels

    def forward(self, spec, lengths, g=None, eps=None, generator=None):
        """spec [B, T, bins], lengths [B] → (z, m, logs, mask).  ``eps``
        [B, T, out] injects the noise; None draws it from ``generator``."""
        x_mask = length_mask(lengths, spec.shape[1], spec.dtype)
        x = self.enc(self.pre(spec) * x_mask, x_mask, g=g)
        stats = self.proj(x) * x_mask
        m, logs = stats[..., :self.out_channels], stats[..., self.out_channels:]
        if eps is None:
            eps = torch.randn(m.shape, generator=generator, device=m.device)
        z = (m + eps.to(m.dtype) * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask


class ResidualCouplingBlock(nn.Module):
    """4 × (mean-only coupling, flip); reference names ``flows.{0,2,4,6}``.
    Forward maps the posterior z to z_p (training); reverse undoes it."""

    def __init__(self, channels, hidden_channels, kernel_size=5, dilation_rate=1,
                 n_layers=4, n_flows=4, gin_channels=0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        for flow in (reversed(self.flows) if reverse else self.flows):
            x = flow(x, x_mask, g=g, reverse=reverse)
        return x


class FramePriorNet(nn.Module):
    def __init__(self, hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                 p_dropout: float = 0.0):
        super().__init__()
        self.fft_block = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                                 kernel_size, p_dropout=p_dropout)

    def forward(self, x_frame, x_mask, generator=None):
        return self.fft_block(x_frame * x_mask, x_mask, generator)


class Projection(nn.Module):
    def __init__(self, hidden_channels, out_channels):
        super().__init__()
        self.out_channels = out_channels
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x, x_mask):
        stats = self.proj(x) * x_mask
        return stats[..., :self.out_channels], stats[..., self.out_channels:]


def _inference(method):
    """Run an inference method under no_grad and in eval mode (no dropout,
    whatever mode the model is in), as the JAX package's deterministic
    inference; the mode is restored after.  Each switch walks the whole
    module tree, in a ``modes`` span."""
    @functools.wraps(method)
    def wrapper(self, *args, **kw):
        was_training = self.training
        with profiling.span("modes"):
            self.eval()
        try:
            with torch.no_grad():
                return method(self, *args, **kw)
        finally:
            with profiling.span("modes"):
                self.train(was_training)
    return wrapper


def _cast_floats(tree, dtype):
    """Every floating tensor of a (nested) tuple cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return tuple(_cast_floats(t, dtype) for t in tree)
    return tree


class Synthesizer(nn.Module):
    """The generator network; ``policy`` fixes the serving decode dtype,
    ``bf16_stages`` the training stages that compute in bf16."""

    def __init__(self, n_vocab: int, spec_channels: int, inter_channels: int = 192,
                 hidden_channels: int = 192, filter_channels: int = 768, n_heads: int = 2,
                 n_layers: int = 4, kernel_size: int = 3, resblock: str = "1",
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5),) * 3,
                 upsample_rates=(8, 8, 4, 2), upsample_initial_channel: int = 512,
                 upsample_kernel_sizes=(16, 16, 4, 4), n_speakers: int = 0,
                 gin_channels: int = 0, use_sdp: bool = False,
                 policy: ServingPolicy = FLOAT32, p_dropout: float = 0.1,
                 segment_size: int = 32, bf16_stages: Tuple[str, ...] = (),
                 train_fused_wn: bool = True, train_fused_attn: bool = True):
        super().__init__()
        self.policy = policy
        self.n_speakers = n_speakers
        self.segment_size = segment_size   # frames
        self.bf16_stages = tuple(bf16_stages)
        h, f = hidden_channels, filter_channels
        self.enc_p = TextEncoder(n_vocab, h, f, n_heads, n_layers, kernel_size, p_dropout)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, h, 5, 1, 16,
                                      gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, h, 5, 1, 4,
                                          gin_channels=gin_channels)
        self.duration_predictor = DurationPredictor(h, 256, 3, gin_channels=gin_channels)
        self.frame_prior_net = FramePriorNet(h, f, n_heads, n_layers, kernel_size, p_dropout)
        self.pitch_predictor = PitchPredictor(h, f, n_heads, kernel_size,
                                              gin_channels=gin_channels, p_dropout=p_dropout)
        self.energy_predictor = EnergyPredictor(h, gin_channels=gin_channels)
        self.project = Projection(h, inter_channels)
        self.pitch_prenet = Conv1d(1, h, 3, padding=1)
        self.energy_prenet = Conv1d(1, h, 3, padding=1)
        if n_speakers > 1:
            self.emb_g = nn.Embedding(n_speakers, gin_channels, _weight=torch.empty(
                n_speakers, gin_channels))
        # registered last, so that a seed draws the same weights for the
        # other modules with and without it (random_init_)
        self.sdp = (StochasticDurationPredictor(h, 192, 3, 0.5, 4, gin_channels=gin_channels)
                    if use_sdp else None)
        # the training dispatch switches (train.fused_wn, fused_attn); serving
        # reads neither
        for mod in self.modules():
            if isinstance(mod, WN):
                mod.fused_train = train_fused_wn
            elif isinstance(mod, MultiHeadAttention):
                mod.fused_train = train_fused_attn

    @classmethod
    def from_config(cls, cfg: Config, n_vocab: int,
                    policy: ServingPolicy = FLOAT32) -> "Synthesizer":
        m = cfg.model
        if cfg.train.folded_mrf:
            _note_unfolded_decoder()
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
            use_sdp=m.use_sdp, policy=policy, p_dropout=m.p_dropout,
            segment_size=cfg.train.segment_size // cfg.data.hop_length,
            train_fused_wn=cfg.train.fused_wn, train_fused_attn=cfg.train.fused_attn)

    def _speaker(self, sid):
        if self.n_speakers > 1 and sid is not None:
            g = self.emb_g(sid)[:, None, :]
            # between stages activations are f32: an embedding cast by name
            # (bf16_only) reaches f32 modules, where flax would promote it
            return g.float() if self.bf16_stages else g
        return None

    def _stage(self, name: str, fn, *args, **kw):
        """Run ``fn`` with its float tensor arguments in bf16 and its float
        outputs back in f32 when ``name`` is in ``bf16_stages``."""
        if name not in self.bf16_stages:
            return fn(*args, **kw)
        out = fn(*_cast_floats(args, torch.bfloat16),
                 **{k: _cast_floats(v, torch.bfloat16) for k, v in kw.items()})
        return _cast_floats(out, torch.float32)

    def forward(self, phonemes, phoneme_lengths, f0, energy, duration, spec, spec_lengths,
                sid=None, generator=None, seed_generator=None, eps_q=None, ids_slice=None):
        """Training forward (``vispeech_tpu/models/synthesizer.py:391-468``).

        phonemes, f0 [Hz], energy, duration [frames]: [B, N]; spec [B, T,
        bins]; lengths [B].  ``generator`` (on the model's device) draws the
        posterior noise and the segment starts, ``seed_generator`` (CPU) the
        attention dropout seeds; ``eps_q`` [B, T, inter] and ``ids_slice``
        [B] inject them instead.  → (audio segment [B, S·hop, 1], l_length,
        l_pitch, l_energy, ids_slice, frame_mask, y_mask, (z, z_p, m_p,
        logs_p, m_q, logs_q), pred_f0, pred_norm_energy, norm_energy)."""
        g = self._speaker(sid)
        x, x_mask = self._stage("enc_p", self.enc_p, phonemes, phoneme_lengths,
                                generator=seed_generator)

        logw_ = torch.log(duration.float() + 1.0)[..., None] * x_mask
        logw = self._stage("heads", self.duration_predictor, x, x_mask, g=g)
        l_length = torch.sum((logw - logw_) ** 2) / torch.sum(x_mask)

        lf0 = f0_to_lf0(f0)
        pred_lf0 = self._stage("heads", self.pitch_predictor, x, x_mask, g=g,
                               generator=seed_generator)
        l_pitch = torch.mean((lf0 - pred_lf0) ** 2)
        x = x + self._stage("heads", self.pitch_prenet, lf0[..., None])
        pred_f0 = lf0_to_f0(pred_lf0)

        norm_energy = normalize_energy(energy)
        pred_norm_energy = self._stage("heads", self.energy_predictor, x, g=g)
        l_energy = torch.mean((norm_energy - pred_norm_energy) ** 2)
        x = x + self._stage("heads", self.energy_prenet, norm_energy[..., None])

        t_frames = spec.shape[1]
        x_frame, frame_lengths = length_regulate(x, duration, t_frames)
        frame_mask = length_mask(frame_lengths, t_frames, x.dtype)
        x_frame = self._stage("fpn", self.frame_prior_net, x_frame, frame_mask,
                              generator=seed_generator)
        m_p, logs_p = self._stage("project", self.project, x_frame, frame_mask)

        z, m_q, logs_q, y_mask = self._stage("enc_q", self.enc_q, spec, spec_lengths, g=g,
                                             eps=eps_q, generator=generator)
        z_p = self._stage("flow", self.flow, z, y_mask, g=g)

        z_slice, ids_slice = rand_slice_segments(z, spec_lengths, self.segment_size,
                                                 generator, ids=ids_slice)
        # kernels C and D have no backward: training decodes every stage with
        # the plain ResBlock1, whatever train.folded_mrf says
        dec = partial(self.dec, fused=False)
        if "dec_body" in self.bf16_stages:
            o = self._stage("dec_body", partial(dec, tail_f32=True), z_slice, g=g)
        else:
            # A whole-graph scope hands bf16 activations to the decoder; flax
            # computes an op in the promotion of its input's and parameters'
            # dtypes, where the port's layers would cast their weights down
            dtype = torch.promote_types(z_slice.dtype, self.dec.conv_pre.weight.dtype)
            o = self._stage("dec", dec, *_cast_floats((z_slice, g), dtype))
        return (o, l_length, l_pitch, l_energy, ids_slice, frame_mask, y_mask,
                (z, z_p, m_p, logs_p, m_q, logs_q), pred_f0, pred_norm_energy, norm_energy)

    @_inference
    def infer(self, phonemes, phoneme_lengths, t_frames: int, sid=None,
              noise_scale: float = 1.0, max_len: Optional[int] = None,
              energy_control=None, pitch_control=None, duration_control=None,
              eps: Optional[torch.Tensor] = None, generator=None,
              eps_w: Optional[torch.Tensor] = None):
        """→ (audio [B, T·hop, 1], frame_mask, (z, z_p, m_p, logs_p), duration,
        f0, energy).  Noise as ``infer_prior``."""
        z_p, frame_mask, duration, f0, energy, (m_p, logs_p) = self.infer_prior(
            phonemes, phoneme_lengths, t_frames, sid=sid, noise_scale=noise_scale,
            energy_control=energy_control, pitch_control=pitch_control,
            duration_control=duration_control, eps=eps, generator=generator,
            eps_w=eps_w)
        o, z, frame_mask = self.infer_decode(z_p, frame_mask, sid=sid, max_len=max_len)
        return o, frame_mask, (z, z_p, m_p, logs_p), duration, f0, energy

    @_inference
    def infer_prior(self, phonemes, phoneme_lengths, t_frames: int, sid=None,
                    noise_scale: float = 1.0, energy_control=None, pitch_control=None,
                    duration_control=None, eps: Optional[torch.Tensor] = None,
                    generator=None, eps_w: Optional[torch.Tensor] = None):
        """Text → z_p = m_p + eps·exp(logs_p)·noise_scale over a static
        ``t_frames`` budget.  ``eps`` [B, T, inter] injects the prior noise;
        None draws it from ``generator``.  With the stochastic duration
        predictor (``use_sdp``) a scalar or None duration control samples
        logw from it at ``noise_scale``: ``eps_w`` [B, N, 2] injects its
        noise, else it is drawn from ``generator`` before ``eps``.
        → (z_p, frame_mask, duration, f0 [Hz], energy, (m_p, logs_p))."""
        with profiling.span("prior"):
            g = self._speaker(sid)
            x, x_mask = self.enc_p(phonemes, phoneme_lengths)

            if _is_array(duration_control):
                duration = duration_control.to(x.dtype)
            else:
                if self.sdp is not None:
                    logw = self.sdp(x, x_mask, g=g, reverse=True, noise_scale=noise_scale,
                                    noise=eps_w, generator=generator)
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

    @_inference
    def infer_decode(self, z_p, frame_mask, sid=None, max_len: Optional[int] = None):
        """Flow reverse → vocoder in the policy's decode dtype.
        → (audio [B, T·hop, 1] f32, z, frame_mask)."""
        g = self._speaker(sid)
        with profiling.span("flow"):
            z = self.flow(z_p, frame_mask, g=g, reverse=True) * frame_mask
        if max_len is not None:
            z, frame_mask = z[:, :max_len], frame_mask[:, :max_len]
        return self._decode(z, g), z, frame_mask

    def _decode(self, z, g):
        """The vocoder in the policy's decode dtype (fused: kernels C and D
        at the narrow stages) → audio [B, T·hop, 1] f32."""
        dtype = self.policy.torch_decode_dtype
        with profiling.span("vocoder"):
            o = self.dec(z.to(dtype), g=None if g is None else g.to(dtype))
            return o.float()

    @_inference
    def voice_conversion(self, spec, spec_lengths, sid_src, sid_tgt,
                         eps: Optional[torch.Tensor] = None, generator=None):
        """Any-to-any conversion through the shared flow prior
        (``vispeech_tpu/models/synthesizer.py:635``): the posterior z of
        ``spec`` [B, T, bins] under the source speaker, the couplings
        forward with it and in reverse with the target, then the vocoder.
        ``eps`` [B, T, inter] injects the posterior noise; None draws it from
        ``generator``.  → (audio [B, T·hop, 1] f32, y_mask, (z, z_p, z_hat))."""
        if self.n_speakers <= 1:
            raise ValueError("voice conversion requires speakers (n_speakers > 1)")
        g_src = self.emb_g(sid_src)[:, None, :]
        g_tgt = self.emb_g(sid_tgt)[:, None, :]
        z, _, _, y_mask = self.enc_q(spec, spec_lengths, g=g_src, eps=eps,
                                     generator=generator)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow(z_p, y_mask, g=g_tgt, reverse=True)
        return self._decode(z_hat * y_mask, g_tgt), y_mask, (z, z_p, z_hat)

    @_inference
    def predict_durations(self, phonemes, phoneme_lengths, sid=None):
        """Duration-only pass → frame counts [B, N] (≥ 0)."""
        with profiling.span("prior"):
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
    gains = ‖v‖, embeddings and relative tables normal, the duration flows'
    affines N(0, 0.1²), norms 1 / 0.  Works for the discriminators as well."""
    gen = torch.Generator().manual_seed(seed)

    def fill(p, values):
        p.copy_(values.to(p.device, p.dtype))

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    for name, mod in model.named_modules():
        if isinstance(getattr(mod, "weight_v", None), torch.Tensor):   # any weight norm
            v = mod.weight_v
            if name.startswith("dec."):
                fill(v, torch.randn(v.shape, generator=gen) * 0.01)
            else:
                fill(v, uniform(v.shape, v[0].numel()))
            dims = tuple(range(1, v.dim()))
            fill(mod.weight_g, v.float().pow(2).sum(dim=dims, keepdim=True).sqrt())
            fill(mod.bias, uniform(mod.bias.shape, v[0].numel()))
        elif isinstance(mod, (Conv1d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            fill(mod.weight, uniform(mod.weight.shape, fan_in))
            if mod.bias is not None:
                fill(mod.bias, uniform(mod.bias.shape, fan_in))
        elif isinstance(mod, nn.Embedding):
            std = mod.embedding_dim ** -0.5 if name.endswith("symbol_emb") else 1.0
            fill(mod.weight, torch.randn(mod.weight.shape, generator=gen) * std)
        elif isinstance(mod, MultiHeadAttention) and mod.emb_rel_k is not None:
            d = mod.emb_rel_k.shape[-1]
            for p in (mod.emb_rel_k, mod.emb_rel_v):
                fill(p, torch.randn(p.shape, generator=gen) * d ** -0.5)
        elif isinstance(mod, ElementwiseAffine):
            for p in (mod.m, mod.logs):
                fill(p, torch.randn(p.shape, generator=gen) * 0.1)
        elif isinstance(mod, LayerNorm):
            mod.gamma.fill_(1.0)
            mod.beta.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
