"""Spectrograms for training (``vispeech_tpu/dsp``): linear magnitude by a
matmul DFT and Slaney log-mel, as plain PyTorch."""

from vispeech_tpu_torch.dsp.mel import mel_filterbank  # noqa: F401
from vispeech_tpu_torch.dsp.stft import (  # noqa: F401
    mel_spectrogram,
    spec_to_mel,
    spectrogram,
)
