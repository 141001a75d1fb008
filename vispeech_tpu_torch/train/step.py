"""One GAN training step (``vispeech_tpu/train/step.py``).

The same order as the JAX step: ONE generator forward, whose autograd graph
is kept; the discriminator update on its detached output; then the
generator loss against the *updated* discriminator, backpropagated through
the saved graph (no second generator forward).

Precision (``train.fp16_run``), the JAX step's cast rules:
``cfg.train.effective_bf16_stages()`` names the generator stages that
compute in bf16 (``Synthesizer._stage``: float inputs cast to bf16 at the
boundary, outputs back to f32).  ``g_param_cast`` casts the parameters of
those stages' modules to bf16 inside the differentiated call, so
gradients, master weights and optimizer state stay f32.  ``tail_f32``
(the default scope) is every stage with the decoder as ``dec_body``, its
conv_post and tanh f32; ``bf16_only`` lists the stages (``dec`` casts the
whole decoder, ``dec_body`` all but conv_post), or raw module names.  The
whole-graph scopes ``stable`` (every module but the decoder) and ``full``
(everything) have no stage boundaries: their batch's f0, energy and spec
are cast to bf16 as well, and the Synthesizer promotes the decoder's
inputs to its parameters' dtype where they differ, as flax does.  The
discriminators, their parameters and both of their inputs are bf16 under
``bf16_disc`` and under ``full``; else f32.  The generator's outputs are
cast to f32 before any loss, and every loss is f32.

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

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank runs the step
on its share of the global batch and both networks' gradients are averaged
over the ranks after ``backward``, before the grad norm and the update, so
every replica takes the global batch's step.  The losses that divide by a
masked count (``l_length`` by the phonemes, ``kl`` by the frames) are
rescaled by ``world · local count / global count``, so that the average is
the global batch's ratio; the others are means over equal local shapes,
whose average is already the global mean.  Data rank r seeds its streams
``seed + RANK_SEED_STRIDE · r`` (rank 0 as one process does), so the data
ranks draw distinct noise, segments and dropout masks.

Tensor parallelism (the mesh's model axis, ``parallel/sharding.py``): the
ranks of a model group run the step on the same share and the same random
streams, each holding its slice of the sharded generator parameters
(``plan``).  After ``backward`` one all-reduce over the model group sums
the partial gradients of the whole parameters that a column-parallel conv
reads through its slice (its gains and bias) and averages the replicated
ones, both networks', whose copies it so keeps bit-equal whatever the
backward rounded; then every gradient, slice or whole, is averaged over
the data axis (``Mesh.average_grads_``).  The generator's grad norm sums
the slices' squares over the model group and counts each replicated
parameter once.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vispeech_tpu_torch.config import Config
from vispeech_tpu_torch.dsp import mel_spectrogram, spec_to_mel, spectrogram
from vispeech_tpu_torch.ops.masking import grad_global_norm, length_mask, slice_segments
from vispeech_tpu_torch.parallel import Mesh
from vispeech_tpu_torch.parallel.sharding import ShardPlan
from vispeech_tpu_torch.train import losses as L

# stage (``Synthesizer.bf16_stages``) → the generator's top-level modules
# whose parameters it casts
STAGE_PARAM_KEYS = {
    "enc_p": ("enc_p",),
    "heads": ("duration_predictor", "pitch_predictor", "energy_predictor",
              "pitch_prenet", "energy_prenet"),
    "fpn": ("frame_prior_net",),
    "project": ("project",),
    "enc_q": ("enc_q",),
    "flow": ("flow",),
    "dec": ("dec",),
    # the decoder with an f32 tail: conv_post (and tanh) stay f32
    "dec_body": ("dec",),
}


def g_param_cast(cfg: Config):
    """fn(name, parameter) → the tensor the generator's forward uses under
    ``cfg.train``: the parameter cast to bf16 or the f32 parameter itself,
    by ``vispeech_tpu/train/step.py:104-140``'s rules.  None when
    ``fp16_run`` is off.  Raises what ``effective_bf16_stages`` raises."""
    t = cfg.train
    if not t.fp16_run:
        return None
    stages = t.effective_bf16_stages()
    if stages:
        keys = {k for s in stages for k in STAGE_PARAM_KEYS.get(s, (s,))}
        dec_tail_f32 = "dec_body" in stages

        def cast_module(k: str) -> bool:
            return k in keys
    else:
        dec_tail_f32 = False
        full = t.bf16_scope == "full"

        def cast_module(k: str) -> bool:
            return full or k != "dec"

    def cast(name: str, p: torch.Tensor) -> torch.Tensor:
        if not cast_module(name.split(".", 1)[0]):
            return p
        if dec_tail_f32 and name.startswith("dec.conv_post."):
            return p
        return p.to(torch.bfloat16)

    return cast


def d_dtype(cfg: Config) -> torch.dtype:
    """The discriminators' compute dtype: bf16 under ``fp16_run`` with
    ``bf16_disc``, or with the ``full`` scope and no ``bf16_only``."""
    t = cfg.train
    if t.fp16_run and ((t.bf16_scope == "full" and not t.effective_bf16_stages())
                       or t.bf16_disc):
        return torch.bfloat16
    return torch.float32


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
    ``seed_generator`` (CPU) the attention dropout seeds.  ``mesh`` (None:
    one process) is the data axis this rank's share of the batch is on,
    ``plan`` (``shard_model_``'s; None: no model axis) the generator's
    sharded parameters."""

    def __init__(self, cfg: Config, model_g: nn.Module, model_d: nn.Module,
                 steps_per_epoch: int = 1000, tf32: Optional[bool] = None,
                 mesh: Optional[Mesh] = None, plan: Optional[ShardPlan] = None):
        self.cfg = cfg
        self.model_g, self.model_d = model_g, model_d
        self.mesh = mesh or Mesh()
        self.steps_per_epoch = steps_per_epoch
        device = next(model_g.parameters()).device
        self.tf32 = device.type == "cuda" if tf32 is None else tf32
        model_g.bf16_stages = cfg.train.effective_bf16_stages()
        self.cast = g_param_cast(cfg)
        self.d_dtype = d_dtype(cfg)
        # oneDNN's bf16 grouped-conv weight gradient on the CPU reads memory
        # it never wrote when the input is shorter than the kernel's reach
        # (the scale discriminator's 256-group conv on segments under 512
        # samples): NaN at random.  The CPU's native kernels have no such fault.
        self.native_cpu_convs = device.type == "cpu" and self.d_dtype == torch.bfloat16
        self.plan = plan
        self.opt_g = make_optimizer(cfg, model_g, g_freeze_keys(cfg))
        self.opt_d = make_optimizer(cfg, model_d)
        seed = self.mesh.seed(cfg.train.seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed + 1)
        self.step = 0

    def generator_forward(self, batch: Dict, spec, eps_q=None, ids_slice=None):
        """The Synthesizer's training forward, parameters cast as the
        precision scope says, graph kept; its float outputs in f32."""
        f0, energy = batch["f0"], batch["energy"]
        if self.cast is not None and not self.model_g.bf16_stages:
            # whole-graph scopes: no stage boundary casts the batch
            f0, energy, spec = (x.to(torch.bfloat16) for x in (f0, energy, spec))
        args = (batch["phonemes"], batch["phoneme_lengths"], f0, energy,
                batch["duration"], spec, batch["spec_lengths"], batch["sid"])
        kw = dict(generator=self.generator, seed_generator=self.seed_generator, eps_q=eps_q,
                  ids_slice=ids_slice)
        if self.cast is None:
            return self.model_g(*args, **kw)
        params = {n: self.cast(n, p) for n, p in self.model_g.named_parameters()}
        out = torch.func.functional_call(self.model_g, params, args, kw)
        y_hat, l_length, l_pitch, l_energy, ids, x_mask, y_mask, latents, *rest = out
        return (y_hat.float(), l_length.float(), l_pitch.float(), l_energy.float(), ids,
                x_mask, y_mask, tuple(x.float() for x in latents), *rest)

    def discriminate(self, y, y_hat):
        """The discriminators on (real, generated), parameters and inputs in
        ``d_dtype``."""
        if self.d_dtype == torch.float32:
            return self.model_d(y, y_hat)
        params = {n: p.to(self.d_dtype) for n, p in self.model_d.named_parameters()}
        return torch.func.functional_call(
            self.model_d, params, (y.to(self.d_dtype), y_hat.to(self.d_dtype)))

    def __call__(self, batch: Dict, eps_q=None, ids_slice=None) -> Dict[str, torch.Tensor]:
        native = (torch.backends.mkldnn.flags(enabled=False) if self.native_cpu_convs
                  else contextlib.nullcontext())
        with tf32_mode(self.tf32), native:
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
        # the masked counts of this rank's share → each ratio loss's factor
        counts = torch.stack([length_mask(batch["phoneme_lengths"],
                                          batch["phonemes"].shape[1]).sum(),
                              y_mask.detach().float().sum()])
        ratio_scale = self.mesh.data_size * counts / self.mesh.sum(counts)

        logits_r, logits_g, _, _ = self.discriminate(wav_slice, y_hat.detach())
        loss_d, _, _ = L.discriminator_loss(logits_r, logits_g)
        self.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        self.mesh.average_grads_(list(self.model_d.parameters()))
        grad_norm_d = grad_global_norm(p.grad for p in self.model_d.parameters())
        self.opt_d.step()

        # the generator loss against the updated discriminator
        y_mel = slice_segments(spec_to_mel(spec, d.filter_length, d.n_mel_channels,
                                           d.sampling_rate, d.mel_fmin, d.mel_fmax),
                               ids, seg // d.hop_length)
        y_hat_mel = mel_spectrogram(y_hat[..., 0], d.filter_length, d.n_mel_channels,
                                    d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin,
                                    d.mel_fmax)
        self.model_d.requires_grad_(False)
        try:
            _, logits_g, fmap_r, fmap_g = self.discriminate(wav_slice, y_hat)
        finally:
            self.model_d.requires_grad_(True)
        metrics = {
            "loss/g/gen": L.generator_loss(logits_g)[0],
            "loss/g/fm": L.feature_loss(fmap_r, fmap_g),
            "loss/g/mel": torch.mean(torch.abs(y_mel - y_hat_mel)) * cfg.train.c_mel,
            "loss/g/dur": l_length * ratio_scale[0],
            "loss/g/kl": L.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * cfg.train.c_kl
            * ratio_scale[1],
            "loss/g/pitch": l_pitch,
            "loss/g/energy": l_energy,
        }
        total = sum(metrics.values())
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        params = dict(self.model_g.named_parameters())
        plan = self.plan
        self.mesh.average_grads_(list(params.values()),
                                 [params[k] for k in plan.dims] if plan else (),
                                 [params[k] for k in plan.partial] if plan else ())
        grad_norm_g = self.grad_norm_g()
        self.opt_g.step()
        self.step += 1
        metrics.update({"loss/g/total": total.detach(), "loss/d/total": loss_d.detach(),
                        "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g})
        return {k: v.detach() for k, v in metrics.items()}

    def grad_norm_g(self) -> torch.Tensor:
        """The generator's global grad norm: with a model axis, the slices'
        squares summed over the model group, each replicated parameter
        counted once."""
        if self.plan is None:
            return grad_global_norm(p.grad for p in self.model_g.parameters())
        zero = torch.zeros((), device=self.generator.device)
        sq = {True: [zero], False: [zero]}
        for name, p in self.model_g.named_parameters():
            if p.grad is not None:
                sq[name in self.plan.dims].append(p.grad.float().square().sum())
        sharded = self.plan.shard.all_reduce(torch.stack(sq[True]).sum())
        return torch.sqrt(sharded + torch.stack(sq[False]).sum())
