"""One GAN training step (``vispeech_tpu/train/step.py``).

The same order as the JAX step: ONE generator forward, whose autograd graph
is kept; the discriminator update on its detached output; then the
generator loss against the *updated* discriminator, backpropagated through
the saved graph (no second generator forward).

Precision (``train.fp16_run``): the ``tail_f32`` scope.  The generator's
stages compute in bf16 (``Synthesizer._stage``) with their parameters cast
to bf16 by ``g_param_cast`` inside the differentiated call, so gradients,
master weights and optimizer state stay f32; the decoder's conv_post and
tanh, the speaker embedding, the discriminators and every loss stay f32.
The legacy ``stable`` and ``full`` scopes, ``bf16_only`` and ``bf16_disc``
are not ported (``ROADMAP.md`` queue 1) and raise.

TF32: the JAX package trains its f32 products at the TPU's default
one-pass bf16 precision; TF32 in cuDNN and cuBLAS is the port's counterpart
(kernels E and F do not read it).  ``TrainStep`` turns it on for a model on
the GPU unless ``tf32=False``, which keeps f32 products exact, as the
reference checks need.

Optimizers: AdamW β = (0.8, 0.99), eps 1e-9, weight decay 0.01, the rate
decayed by γ = ``lr_decay`` per epoch; the generator's frozen modules
(``freeze_textencoder`` / ``freeze_decoder``) get a zero update, their
moments still kept, as optax's masked ``set_to_zero`` does.

Device DSP: an int16 waveform comes in and the masked linear spectrogram
is computed on the device (``dsp/stft.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vispeech_tpu_torch.config import Config
from vispeech_tpu_torch.dsp import mel_spectrogram, spec_to_mel, spectrogram
from vispeech_tpu_torch.ops.masking import grad_global_norm, length_mask, slice_segments
from vispeech_tpu_torch.train import losses as L

TAIL_F32_STAGES = ("enc_p", "heads", "fpn", "project", "enc_q", "flow", "dec_body")

# stage → the generator's top-level modules whose parameters it casts
STAGE_PARAM_KEYS = {
    "enc_p": ("enc_p",),
    "heads": ("duration_predictor", "pitch_predictor", "energy_predictor",
              "pitch_prenet", "energy_prenet"),
    "fpn": ("frame_prior_net",),
    "project": ("project",),
    "enc_q": ("enc_q",),
    "flow": ("flow",),
    "dec_body": ("dec",),
}

def train_bf16_stages(cfg: Config) -> Tuple[str, ...]:
    """The generator stages that compute in bf16 under ``cfg.train``."""
    t = cfg.train
    if not t.fp16_run:
        return ()
    if t.bf16_only or t.bf16_disc or t.bf16_scope != "tail_f32":
        raise ValueError(
            f"fp16_run with bf16_scope={t.bf16_scope!r}, bf16_only={t.bf16_only!r}, "
            f"bf16_disc={t.bf16_disc}: only the tail_f32 scope is ported; the legacy "
            f"'stable'/'full' scopes, bf16_only and bf16_disc wait in ROADMAP.md queue 1")
    return TAIL_F32_STAGES


def g_param_cast(cfg: Config):
    """fn(name, parameter) → the tensor the generator's forward uses: bf16
    for the modules of the bf16 stages (the decoder's conv_post excepted),
    the f32 parameter itself otherwise.  None when nothing is cast."""
    stages = train_bf16_stages(cfg)
    if not stages:
        return None
    keys = {k for s in stages for k in STAGE_PARAM_KEYS[s]}

    def cast(name: str, p: torch.Tensor) -> torch.Tensor:
        if name.split(".", 1)[0] in keys and not name.startswith("dec.conv_post."):
            return p.to(torch.bfloat16)
        return p

    return cast


def g_freeze_keys(cfg: Config) -> Tuple[str, ...]:
    keys = []
    if cfg.model.freeze_textencoder:
        keys.append("enc_p")
    if cfg.model.freeze_decoder:
        keys.append("dec")
    return tuple(keys)


def make_optimizer(cfg: Config, model: nn.Module, freeze: Tuple[str, ...] = ()):
    """AdamW with a second, frozen parameter group (rate 0: no update)."""
    active, frozen = [], []
    for name, p in model.named_parameters():
        (frozen if name.split(".", 1)[0] in freeze else active).append(p)
    groups = [{"params": active, "frozen": False}]
    if frozen:
        groups.append({"params": frozen, "frozen": True})
    # one fused update kernel per group on the GPU, in place of PyTorch's
    # per-tensor-list launches
    fused = all(p.is_cuda for p in active + frozen)
    return torch.optim.AdamW(groups, lr=cfg.train.learning_rate,
                             betas=tuple(cfg.train.betas), eps=cfg.train.eps,
                             weight_decay=0.01, fused=fused or None)


def learning_rate(cfg: Config, step: int, steps_per_epoch: int) -> float:
    return cfg.train.learning_rate * cfg.train.lr_decay ** (step // max(steps_per_epoch, 1))


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class TrainStep:
    """``step(batch)`` → metrics; updates both networks and their optimizers.

    ``batch``: the collated tensors on the models' device (phonemes,
    phoneme_lengths, f0, energy, duration, spec, spec_lengths, wav, sid;
    ``spec`` None and ``wav`` int16 under device DSP).  ``generator`` (on
    that device) draws the posterior noise and segment starts,
    ``seed_generator`` (CPU) the attention dropout seeds."""

    def __init__(self, cfg: Config, model_g: nn.Module, model_d: nn.Module,
                 steps_per_epoch: int = 1000, tf32: Optional[bool] = None):
        self.cfg = cfg
        self.model_g, self.model_d = model_g, model_d
        self.steps_per_epoch = steps_per_epoch
        device = next(model_g.parameters()).device
        self.tf32 = device.type == "cuda" if tf32 is None else tf32
        model_g.bf16_stages = train_bf16_stages(cfg)
        self.cast = g_param_cast(cfg)
        self.opt_g = make_optimizer(cfg, model_g, g_freeze_keys(cfg))
        self.opt_d = make_optimizer(cfg, model_d)
        seed = cfg.train.seed
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed + 1)
        self.step = 0

    def generator_forward(self, batch: Dict, spec, eps_q=None, ids_slice=None):
        """The Synthesizer's training forward, parameters cast as the
        precision scope says, graph kept."""
        args = (batch["phonemes"], batch["phoneme_lengths"], batch["f0"], batch["energy"],
                batch["duration"], spec, batch["spec_lengths"], batch["sid"])
        kw = dict(generator=self.generator, seed_generator=self.seed_generator, eps_q=eps_q,
                  ids_slice=ids_slice)
        if self.cast is None:
            return self.model_g(*args, **kw)
        params = {n: self.cast(n, p) for n, p in self.model_g.named_parameters()}
        return torch.func.functional_call(self.model_g, params, args, kw)

    def __call__(self, batch: Dict, eps_q=None, ids_slice=None) -> Dict[str, torch.Tensor]:
        with tf32_mode(self.tf32):
            return self._step(batch, eps_q, ids_slice)

    def _step(self, batch, eps_q, ids_slice):
        cfg, d = self.cfg, self.cfg.data
        seg = cfg.train.segment_size
        wav = batch["wav"]
        if wav.dtype == torch.int16:
            wav = wav.float() / d.max_wav_value
        spec = batch.get("spec")
        if spec is None:
            spec = spectrogram(wav[..., 0], d.filter_length, d.hop_length, d.win_length)
            spec = spec * length_mask(batch["spec_lengths"], spec.shape[1])
        lr = learning_rate(cfg, self.step, self.steps_per_epoch)
        for opt in (self.opt_g, self.opt_d):
            for group in opt.param_groups:
                group["lr"] = 0.0 if group["frozen"] else lr

        (y_hat, l_length, l_pitch, l_energy, ids, _, y_mask,
         (z, z_p, m_p, logs_p, m_q, logs_q), *_) = self.generator_forward(
            batch, spec, eps_q, ids_slice)
        wav_slice = slice_segments(wav, ids * d.hop_length, seg)

        logits_r, logits_g, _, _ = self.model_d(wav_slice, y_hat.detach())
        loss_d, _, _ = L.discriminator_loss(logits_r, logits_g)
        self.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        grad_norm_d = grad_global_norm(p.grad for p in self.model_d.parameters())
        self.opt_d.step()

        # the generator loss against the updated discriminator
        y_mel = slice_segments(spec_to_mel(spec, d.filter_length, d.n_mel_channels,
                                           d.sampling_rate, d.mel_fmin, d.mel_fmax),
                               ids, seg // d.hop_length)
        y_hat_mel = mel_spectrogram(y_hat[..., 0].float(), d.filter_length, d.n_mel_channels,
                                    d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin,
                                    d.mel_fmax)
        self.model_d.requires_grad_(False)
        try:
            _, logits_g, fmap_r, fmap_g = self.model_d(wav_slice, y_hat)
        finally:
            self.model_d.requires_grad_(True)
        metrics = {
            "loss/g/gen": L.generator_loss(logits_g)[0],
            "loss/g/fm": L.feature_loss(fmap_r, fmap_g),
            "loss/g/mel": torch.mean(torch.abs(y_mel - y_hat_mel)) * cfg.train.c_mel,
            "loss/g/dur": l_length.float(),
            "loss/g/kl": L.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * cfg.train.c_kl,
            "loss/g/pitch": l_pitch.float(),
            "loss/g/energy": l_energy.float(),
        }
        total = sum(metrics.values())
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        grad_norm_g = grad_global_norm(p.grad for p in self.model_g.parameters())
        self.opt_g.step()
        self.step += 1
        metrics.update({"loss/g/total": total.detach(), "loss/d/total": loss_d.detach(),
                        "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g})
        return {k: v.detach() for k, v in metrics.items()}
