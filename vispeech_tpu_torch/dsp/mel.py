"""Slaney-scale mel filterbank, computed once on the host in float64
(``vispeech_tpu/dsp/mel.py``): librosa's ``filters.mel`` with htk=False and
norm='slaney'."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

_F_SP = 200.0 / 3.0          # linear region spacing (Hz per mel)
_MIN_LOG_HZ = 1000.0         # switch point to the log region
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    return np.where(freq >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    return np.where(mel >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), _F_SP * mel)


@lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] float32 triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)
