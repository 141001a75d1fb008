"""Pipeline parallelism (``vispeech_tpu/parallel/pipeline.py``): the
Synthesizer inference path split across a 2-rank 'stage' group with a GPipe
microbatch schedule.

The model splits at its natural seam (``models/synthesizer.py``):

- **stage 0** ``Synthesizer.infer_prior``: text encoder → variance adapter
  → length regulation → FramePriorNet → projection → sampled prior z_p
  (kernel A, 14 launches a microbatch at full width);
- **stage 1** ``Synthesizer.infer_decode``: flow reverse → HiFi-GAN
  vocoder (kernel B 4, C 1 and D 1 a microbatch).

Mechanics:

- The batch is cut into M microbatches.  At tick t, stage s processes
  microbatch t − s; M + S − 1 ticks in all, bubble fraction (S−1)/(M+S−1).
  JAX's ``lax.switch`` also computes on bubble ticks and discards the
  result; here a stage skips them, with the same outputs.
- Activations ride the pipeline in a fixed-shape float32 **carrier**
  ``[B_mb, T, C]`` (C = max(hop, inter+1)): stage 0 packs z_p and the frame
  mask into channels and sends it with ``isend``, so it computes the next
  microbatch while the send is in flight; stage 1 unpacks it and banks the
  waveform as [t_out, hop] rows (the carrier's ``[:t_out, :hop]`` in JAX).
  At full width that is [B_mb, 1400, 512], ~2.9 MB a sample.
- Speaker ids and the injected prior noise are given to every rank; each
  stage slices the microbatch it holds, so only the carrier travels.
- The last stage broadcasts the audio over the group: every rank returns
  the whole batch, as the JAX function's full-array output.

Prior noise is injected (``eps``, required) so that the pipeline is
sample-for-sample identical to ``Synthesizer.infer`` on each microbatch
with the same noise.  Transport: ``p2p`` (NCCL on the card, gloo on the
CPU, gloo staged through the host for two ranks on one card).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from vispeech_tpu_torch.parallel import p2p

N_STAGES = 2  # infer_prior | infer_decode (the model's natural seam)


def make_synthesizer_pipeline(model, group: Optional[dist.ProcessGroup], t_frames: int,
                              microbatches: int, noise_scale: float = 0.667,
                              max_len: Optional[int] = None) -> Callable:
    """→ ``fn(phonemes, lengths, sid, eps) -> audio [B, t_out·hop, 1]`` f32
    on every rank of ``group`` (its device: the model's), t_out =
    min(max_len, t_frames).  phonemes [B, N], lengths [B], sid [B] or None,
    eps [B, t_frames, inter].  B must divide into ``microbatches`` equal
    chunks; ``group`` must hold ``N_STAGES`` ranks.  A model with the
    stochastic duration predictor raises."""
    if getattr(model, "sdp", None) is not None:
        raise ValueError(
            "the pipeline takes no durations, and a model with the stochastic duration "
            "predictor (use_sdp) would sample them from a noise stream the pipeline does "
            "not have (the JAX package's pipeline has none either): serve it without "
            "use_sdp, or call Synthesizer.infer with its noise eps_w")
    S = p2p.size(group)
    if S != N_STAGES:
        raise ValueError(f"pipeline needs a {N_STAGES}-rank 'stage' group, got {S}")
    M = microbatches
    hop = 1
    for up in model.dec.ups:
        hop *= up.stride
    c_inter = model.project.out_channels
    c_car = max(hop, c_inter + 1)
    t_out = t_frames if max_len is None else min(max_len, t_frames)

    @torch.no_grad()
    def fn(phonemes, lengths, sid, eps):
        B = phonemes.shape[0]
        if B % M != 0:
            raise ValueError(f"batch size {B} must divide into microbatches={M} equal "
                             f"chunks (got remainder {B % M})")
        if eps is None:
            raise ValueError("the pipeline takes injected prior noise: eps "
                             f"[B, {t_frames}, {c_inter}]")
        B_mb = B // M
        s = p2p.rank(group)
        device = next(model.parameters()).device

        def mb_slice(x, mb):
            return None if x is None else x[mb * B_mb:(mb + 1) * B_mb]

        sends, bank = [], []
        for t in range(M + S - 1):
            mb = t - s
            if not 0 <= mb < M:   # a bubble tick
                continue
            if s == 0:
                z_p, frame_mask, *_ = model.infer_prior(
                    mb_slice(phonemes, mb), mb_slice(lengths, mb), t_frames,
                    sid=mb_slice(sid, mb), noise_scale=noise_scale, eps=mb_slice(eps, mb))
                carrier = torch.zeros(B_mb, t_frames, c_car, dtype=torch.float32,
                                      device=device)
                carrier[..., :c_inter] = z_p
                carrier[..., c_inter] = frame_mask[..., 0]
                sends.append(p2p.isend(carrier, group, 1, tag=mb))
            else:
                carrier = p2p.recv((B_mb, t_frames, c_car), torch.float32, device, group, 0,
                                   tag=mb)
                audio, _, _ = model.infer_decode(
                    carrier[..., :c_inter].contiguous(),
                    carrier[..., c_inter:c_inter + 1].contiguous(),
                    sid=mb_slice(sid, mb), max_len=max_len)
                bank.append(audio.float().reshape(B_mb, t_out, hop))
        for pending in sends:
            pending.wait()
        if s == S - 1:
            out = torch.cat(bank).reshape(B, t_out * hop, 1)
        else:
            out = torch.empty(B, t_out * hop, 1, dtype=torch.float32, device=device)
        dist.broadcast(out, dist.get_global_rank(group, S - 1), group=group)
        return out

    return fn
