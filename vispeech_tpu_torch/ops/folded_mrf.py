"""Polyphase channel-folded MRF stage (``vispeech_tpu/ops/folded_mrf.py``).

``fold`` consecutive samples are packed into the channel axis, so a stage
at C channels over T samples computes at fold·C channels over T/fold folded
frames.  A dilated SAME conv becomes a conv over folded frames whose taps
mix the original taps block-Toeplitz-wise: output phase p at folded frame
t' reads input phase q = (p + off_j) mod fold at frame
t' + (p + off_j) // fold, so

    Wf[m, q·C + ci, p·C + co] = Σ_j w[j, ci, co] · [(p + off_j) // fold == m − pad_lo
                                                  and (p + off_j) % fold == q].

Zero padding in folded frames is zero padding in samples: in exact
arithmetic the folded stage equals the ResBlock1 stage.  Plain PyTorch and
differentiable; it is kernel D's reference (``ops/kernels/
mrf_stage_folded.py``) and the CPU form of the generator's folded stage.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.layers import at_least_f32

# (w1 [U, k, C, C], b1 [U, 1, C], w2, b2): ResBlock1.packed() per branch
BranchWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _fold_scatter(k: int, dilation: int, fold: int) -> Tuple[np.ndarray, int]:
    """0/1 tensor S[j, m, q, p]: original tap j lands on folded tap m with
    input phase q for output phase p; and the left pad in folded frames.
    Offsets are centred: off_j = (j − (k−1)//2) · dilation."""
    c = (k - 1) // 2
    offsets = (np.arange(k) - c) * dilation
    pos = offsets[:, None] + np.arange(fold)[None, :]   # [j, p] = p + off_j
    m = np.floor_divide(pos, fold)
    q = pos - m * fold
    m_min, m_max = int(m.min()), int(m.max())
    s = np.zeros((k, m_max - m_min + 1, fold, fold), np.float32)
    for j in range(k):
        for p in range(fold):
            s[j, m[j, p] - m_min, q[j, p], p] = 1.0
    return s, -m_min   # pad_hi = kf − 1 − pad_lo


def fold_conv_weights(w: torch.Tensor, b: torch.Tensor, dilation: int, fold: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """(Wf [kf, fold·Cin, fold·Cout], bf [fold·Cout], (pad_lo, pad_hi)) of a
    SAME conv with kernel ``w`` [k, Cin, Cout] and bias ``b`` [Cout]."""
    k, cin, cout = w.shape
    s, pad_lo = _fold_scatter(k, dilation, fold)
    kf = s.shape[1]
    sj = torch.as_tensor(s, dtype=w.dtype, device=w.device)
    wf = torch.einsum("kio,kmqp->mqipo", w, sj).reshape(kf, fold * cin, fold * cout)
    return wf, b.repeat(fold), (pad_lo, kf - 1 - pad_lo)


def folded_units(packed: Sequence[BranchWeights], dilations, fold: int):
    """Per branch, per unit: ((Wf1, bf1, pads1), (Wf2, bf2, pads2)), folded
    from the f32 weights (f64 weights stay f64, as ``ops/layers.py``'s
    weight norm keeps them)."""
    return [[tuple(fold_conv_weights(at_least_f32(w[u]), at_least_f32(bias[u, 0]), d, fold)
                   for w, bias, d in ((w1, b1, dil), (w2, b2, 1)))
             for u, dil in enumerate(dils)]
            for (w1, b1, w2, b2), dils in zip(packed, dilations)]


def conv_folded(x: torch.Tensor, wf: torch.Tensor, bf: torch.Tensor,
                pads: Tuple[int, int]) -> torch.Tensor:
    """x [B, Cf, Tf] ⊛ Wf [kf, Cf, Cf] with zero padding ``pads`` (+ bias)."""
    return F.conv1d(F.pad(x, pads), wf.permute(2, 1, 0), bf)


def mrf_stage_folded(x: torch.Tensor, packed: Sequence[BranchWeights],
                     kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]],
                     fold: int) -> torch.Tensor:
    """One MRF stage (the ResBlock1 branches averaged) in folded layout:
    x [B, T, C] → [B, T, C], T % fold == 0.  Weights are folded in f32 (f64
    weights in f64) and cast to x's dtype; the convs and the state run in
    x's dtype, as the JAX package's XLA path does."""
    B, T, C = x.shape
    if T % fold:
        raise ValueError(f"T={T} not divisible by fold={fold}")
    x0 = x.reshape(B, T // fold, fold * C).transpose(1, 2)
    acc = None
    for units in folded_units(packed, dilations, fold):
        xb = x0
        for (wf1, bf1, p1), (wf2, bf2, p2) in units:
            h = conv_folded(F.leaky_relu(xb, 0.1), wf1.to(x.dtype), bf1.to(x.dtype), p1)
            h = conv_folded(F.leaky_relu(h, 0.1), wf2.to(x.dtype), bf2.to(x.dtype), p2)
            xb = xb + h
        acc = xb if acc is None else acc + xb
    return (acc / len(packed)).transpose(1, 2).reshape(B, T, C)
