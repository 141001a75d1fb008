"""Host-side waveform resampling for the server's output-rate conversion
(``vispeech_tpu/dsp/resample.py``).

The reference shells out to ffmpeg per request to deliver 22.05 kHz from the
44.1 kHz model; here it is an in-process polyphase resampler (scipy's
``resample_poly``) with a numpy linear-interpolation path where scipy is
absent.  It works on the host array a request returns, after the card is
done: this is DSP of the output, not a device fallback.
"""

from __future__ import annotations

import math

import numpy as np


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample a 1-D float waveform from sr_in to sr_out."""
    if sr_in == sr_out:
        return wav
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError(f"bad sample rates: {sr_in} -> {sr_out}")
    try:
        from scipy.signal import resample_poly

        g = math.gcd(sr_in, sr_out)
        return resample_poly(
            np.asarray(wav, np.float32), sr_out // g, sr_in // g
        ).astype(np.float32)
    except ImportError:
        n_out = int(round(len(wav) * sr_out / sr_in))
        x_old = np.linspace(0.0, 1.0, num=len(wav), endpoint=False)
        x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        return np.interp(x_new, x_old, wav).astype(np.float32)
