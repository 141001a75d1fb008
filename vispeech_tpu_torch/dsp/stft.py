"""Linear and log-mel spectrograms (``vispeech_tpu/dsp/stft.py``).

Reference semantics: reflect-pad the waveform by (n_fft − hop)/2 on both
sides, center=False, periodic Hann window, magnitude √(re² + im² + 1e-6),
mel = log(clamp(basis · |X|, 1e-5)).  The DFT is one matmul of the frames
with a windowed [n_fft, 2·n_bins] matrix, in f32; the caller keeps TF32 off
where f32 accuracy matters.  Layout: waveforms [B, L] → [B, T, bins].
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vispeech_tpu_torch.dsp.mel import mel_filterbank


@lru_cache(maxsize=8)
def dft_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """[n_fft, 2·(n_fft//2+1)] windowed real-DFT matrix: frames @ W = [re | im]."""
    n_bins = n_fft // 2 + 1
    angle = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    # periodic Hann, as torch.hann_window(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    return np.concatenate([np.cos(angle) * win[:, None], -np.sin(angle) * win[:, None]],
                          axis=1).astype(np.float32)


_CONSTS: dict = {}


def _const(key, make, device) -> torch.Tensor:
    """A host-built matrix, copied to ``device`` once per process."""
    k = (key, str(device))
    if k not in _CONSTS:
        _CONSTS[k] = torch.from_numpy(make()).to(device)
    return _CONSTS[k]


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """[B, L] waveform → [B, T, n_fft//2+1] linear magnitude, f32."""
    pad = (n_fft - hop_length) // 2
    y = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop_length)                 # [B, T, n_fft]
    spec = torch.matmul(frames, _const(("dft", n_fft, win_length),
                                       lambda: dft_matrix(n_fft, win_length), y.device))
    n_bins = n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return torch.sqrt(re * re + im * im + 1e-6)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                fmin: float, fmax: Optional[float]) -> torch.Tensor:
    """[B, T, bins] linear → [B, T, n_mels] log-mel."""
    basis = _const(("mel", sampling_rate, n_fft, n_mels, fmin, fmax),
                   lambda: mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax),
                   spec.device)
    return torch.log(torch.clamp(torch.matmul(spec, basis.t()), min=1e-5))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                    hop_length: int, win_length: int, fmin: float,
                    fmax: Optional[float]) -> torch.Tensor:
    """[B, L] waveform → [B, T, n_mels] log-mel."""
    return spec_to_mel(spectrogram(y, n_fft, hop_length, win_length), n_fft, n_mels,
                       sampling_rate, fmin, fmax)
