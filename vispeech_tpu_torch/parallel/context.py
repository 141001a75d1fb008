"""Context (sequence) parallelism (``vispeech_tpu/parallel/context.py``):
ring attention over the frame axis and a time-sharded vocoder with halo
exchange.

The JAX package runs both under ``shard_map`` over a named mesh axis, with
``ppermute`` neighbour hops.  Here each process is one rank of a
``torch.distributed`` group (``context_groups`` lays them out as JAX's
mesh), and the hops are ``p2p.shift``: NCCL on the card, gloo on the CPU,
gloo staged through the host for two ranks sharing one card.

- ``ring_relative_self_attention``: the FramePriorNet attention with the
  window-w relative bias, frame axis sharded P ways.  K/V/mask chunks
  rotate around the ring; each step updates an online softmax (running
  max, sum, value accumulator) plus a band accumulator for the
  relative-value correction, so the full [T, T] score matrix never exists
  anywhere.  Plain PyTorch products, as the JAX function's are plain
  ``einsum``: there is no kernel here.
- ``make_generator_context_parallel``: overlap-save vocoder — each shard
  gathers an H-frame halo from its ring neighbours, runs the full HiFi-GAN
  stack locally (kernels C and D on each shard), and crops the halo at
  output rate.

Both are forward only (inference), as every JAX caller uses them.  The
ring rotates P − 1 times (JAX's loop also rotates after its last step and
drops the result).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from vispeech_tpu_torch.parallel import p2p

NEG_INF = -1e4  # reference masked_fill (attentions.py:161)
GENERATOR_HALO_FRAMES = 32  # ≥ latent receptive field of the 8·8·4·2 stack


def context_groups(context: int, data: int = 1
                   ) -> Tuple[Optional[dist.ProcessGroup], Optional[dist.ProcessGroup]]:
    """(this rank's context group, its data group) on an initialized world
    of ``data × context`` ranks, laid out as JAX's ``devices.reshape(data,
    context)``: rank = data_rank · context + context_rank, so a context
    group is ``context`` consecutive ranks and a data group holds the ranks
    of one context rank.  An axis of size 1 gives None (a group of one).
    Every rank creates every group, in the same order."""
    world = dist.get_world_size()
    if context < 1 or data < 1 or context * data != world:
        raise ValueError(f"data={data} × context={context} != the world size {world}")
    r = dist.get_rank()
    ctx = data_group = None
    if context > 1:
        groups = [dist.new_group(list(range(d * context, (d + 1) * context)))
                  for d in range(data)]
        ctx = groups[r // context]
    if data > 1:
        groups = [dist.new_group(list(range(c, world, context))) for c in range(context)]
        data_group = groups[r % context]
    return ctx, data_group


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("context parallelism is forward only: call it under "
                           "torch.no_grad()")


def _band_bias(q_scaled: torch.Tensor, rel_k: torch.Tensor, row0: int, col0: int,
               window: int):
    """Banded relative-key bias for a (q-chunk, k-chunk) pair with global
    offsets row0/col0 → bias [B, H, Tq, Tk], diff [Tq, Tk] = col − row
    (kernel A's ``delta`` = key − row)."""
    Tq = q_scaled.shape[-2]
    Tk = Tq  # equal chunking around the ring
    q_rel = torch.einsum("bhtd,md->bhtm", q_scaled, rel_k)  # [B, H, Tq, 2w+1]
    row = torch.arange(Tq, device=q_scaled.device)[:, None] + row0
    col = torch.arange(Tk, device=q_scaled.device)[None, :] + col0
    diff = col - row
    bias = torch.zeros(q_scaled.shape[:-1] + (Tk,), dtype=q_scaled.dtype,
                       device=q_scaled.device)
    for d_off in range(-window, window + 1):
        sel = (diff == d_off).to(q_scaled.dtype)[None, None]
        bias = bias + sel * q_rel[..., d_off + window][..., None]
    return bias, diff


def ring_relative_self_attention(q, k, v, rel_k, rel_v, key_mask,
                                 group: Optional[dist.ProcessGroup], window: int = 4):
    """Exact masked softmax attention with relative bias, sequence sharded
    over ``group``.  q, k, v: this rank's chunks [B, H, T/P, d]; rel_k,
    rel_v [2w+1, d] (heads-shared); key_mask [B, T/P] → this rank's output
    chunk [B, H, T/P, d]."""
    _refuse_grad(q, k, v, rel_k, rel_v)
    B, H, Tl, d = q.shape
    P, idx = p2p.size(group), p2p.rank(group)
    qs = q * (1.0 / math.sqrt(d))
    rel_k = rel_k.to(qs.dtype)
    W = 2 * window + 1
    row0 = idx * Tl

    k_blk, v_blk, m_blk = k, v, key_mask
    m_run = torch.full((B, H, Tl), -math.inf, dtype=qs.dtype, device=q.device)
    l_run = torch.zeros((B, H, Tl), dtype=qs.dtype, device=q.device)
    acc = torch.zeros((B, H, Tl, d), dtype=qs.dtype, device=q.device)
    acc_band = torch.zeros((B, H, Tl, W), dtype=qs.dtype, device=q.device)
    for s in range(P):
        col0 = ((idx - s) % P) * Tl   # the chunk came from rank idx − s
        bias, diff = _band_bias(qs, rel_k, row0, col0, window)
        scores = torch.matmul(qs, k_blk.transpose(-1, -2)) + bias
        scores = torch.where(m_blk[:, None, None, :] > 0, scores,
                             torch.full_like(scores, NEG_INF))

        m_new = torch.maximum(m_run, scores.amax(-1))
        rescale = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * rescale + p.sum(-1)
        acc = acc * rescale[..., None] + torch.matmul(p, v_blk)
        # band accumulation for the relative-value correction
        band = torch.stack([(p * (diff == d_off)[None, None]).sum(-1)
                            for d_off in range(-window, window + 1)], dim=-1)  # [B, H, Tl, W]
        acc_band = acc_band * rescale[..., None] + band
        m_run = m_new
        if s < P - 1:   # rotate k/v/mask to the next rank
            k_blk, v_blk, m_blk = p2p.shift((k_blk, v_blk, m_blk), group, 1)

    l_safe = torch.clamp(l_run, min=1e-30)
    out = acc / l_safe[..., None]
    band_p = acc_band / l_safe[..., None]
    return out + torch.einsum("bhtm,md->bhtd", band_p, rel_v.to(out.dtype))


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not divide into {parts} equal shards")
    return n // parts


def _gather(t: torch.Tensor, group: Optional[dist.ProcessGroup], dim: int) -> torch.Tensor:
    """The group's chunks of ``t`` concatenated along ``dim``, in rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(p2p.size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def make_ring_attention(group: Optional[dist.ProcessGroup], window: int = 4,
                        batch_group: Optional[dist.ProcessGroup] = None) -> Callable:
    """Ring attention with full arrays in and out, frame axis sharded over
    ``group`` (JAX's ``shard_map`` wrapper): each rank takes its frame
    chunk and, with ``batch_group``, its batch slice (JAX's
    ``batch_axis``), runs the ring and all-gathers the output chunks.
    → ``fn(q, k, v, rel_k, rel_v, key_mask)`` with q, k, v [B, H, T, d],
    rel_k, rel_v [2w+1, d], key_mask [B, T] → [B, H, T, d] on every rank.
    Raises when P does not divide T or ``batch_group``'s size B."""
    def fn(q, k, v, rel_k, rel_v, key_mask):
        B, _, T, _ = q.shape
        tl = _split(T, p2p.size(group), "frame count")
        bl = _split(B, p2p.size(batch_group), "batch size")
        rows = slice(p2p.rank(batch_group) * bl, (p2p.rank(batch_group) + 1) * bl)
        frames = slice(p2p.rank(group) * tl, (p2p.rank(group) + 1) * tl)
        out = ring_relative_self_attention(
            q[rows, :, frames], k[rows, :, frames], v[rows, :, frames], rel_k, rel_v,
            key_mask[rows, frames], group, window)
        return _gather(_gather(out, group, 2), batch_group, 0)

    return fn


def make_generator_context_parallel(generator_apply: Callable,
                                    group: Optional[dist.ProcessGroup], hop_length: int,
                                    halo: int = GENERATOR_HALO_FRAMES,
                                    batch_group: Optional[dist.ProcessGroup] = None
                                    ) -> Callable:
    """Overlap-save time-sharded vocoder: ``fn(z, g)`` with z [B, T, C]
    and g [B, 1, G] (or None) → audio [B, T·hop, 1] on every rank.

    Each rank takes its T/P frames (and, with ``batch_group``, its batch
    slice), sends its last ``halo`` frames to rank i+1 and its first
    ``halo`` to rank i−1, zeroes the wrapped-around halos at the two
    global ends, runs ``generator_apply(z_ext, g)`` on [B, T/P + 2·halo, C]
    (the port's ``Generator.forward`` layout), crops ``halo·hop`` samples
    on each side and all-gathers.  All interior samples are exact for halo
    ≥ the receptive field; only the outermost ~RF samples of the WHOLE
    utterance differ from the unsharded computation, because an explicit
    zero halo is not identical to per-layer conv zero-padding once biases
    propagate.  Raises where JAX would silently misbehave: P not dividing
    T, or T/P < halo (JAX's ``z_local[:, -halo:]`` would take a shorter
    halo and crop the wrong samples)."""
    if halo < 1:
        raise ValueError(f"halo={halo}: the overlap-save vocoder needs at least one frame")

    def fn(z, g):
        B, T, _ = z.shape
        P, i = p2p.size(group), p2p.rank(group)
        tl = _split(T, P, "frame count")
        if tl < halo:
            raise ValueError(f"{tl} frames a shard (T={T}, P={P}) is less than the halo "
                             f"of {halo} frames")
        bl = _split(B, p2p.size(batch_group), "batch size")
        rows = slice(p2p.rank(batch_group) * bl, (p2p.rank(batch_group) + 1) * bl)
        z_local = z[rows, i * tl:(i + 1) * tl]
        left = p2p.shift(z_local[:, -halo:], group, 1)     # from rank i − 1
        right = p2p.shift(z_local[:, :halo], group, -1)    # from rank i + 1
        if i == 0:
            left = torch.zeros_like(left)
        if i == P - 1:
            right = torch.zeros_like(right)
        z_ext = torch.cat([left, z_local, right], dim=1)
        audio = generator_apply(z_ext, None if g is None else g[rows])
        audio = audio[:, halo * hop_length:audio.shape[1] - halo * hop_length]
        return _gather(_gather(audio, group, 1), batch_group, 0)

    return fn
