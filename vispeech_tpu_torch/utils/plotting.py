"""Matplotlib figures as numpy images for TensorBoard
(``vispeech_tpu/utils/plotting.py``).  matplotlib is imported at the first
call, under the "Agg" backend; where it is absent that call raises
ImportError."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    _pyplot().close(fig)
    return buf.copy()


def spectrogram_image(spec: np.ndarray, title: Optional[str] = None) -> np.ndarray:
    """[C, T] or [T, C] spectrogram → HWC uint8 image."""
    plt = _pyplot()
    spec = np.asarray(spec)
    if spec.shape[0] > spec.shape[1]:  # time-major → channel-major for display
        spec = spec.T
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Channels")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return _fig_to_array(fig)


def line_plot_image(series: Sequence[np.ndarray], labels: Optional[Sequence[str]] = None,
                    title: Optional[str] = None) -> np.ndarray:
    """Overlaid line plot (ground-truth against predicted F0 or energy)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 2))
    for i, y in enumerate(series):
        label = labels[i] if labels and i < len(labels) else None
        ax.plot(np.asarray(y).reshape(-1), label=label)
    if labels:
        ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return _fig_to_array(fig)


def alignment_image(attn: np.ndarray, title: Optional[str] = None) -> np.ndarray:
    """[N, T] duration or alignment matrix → HWC uint8 image."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(attn), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Phonemes")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return _fig_to_array(fig)


def durations_to_alignment(durations: np.ndarray, t_frames: Optional[int] = None) -> np.ndarray:
    """Per-phoneme frame counts → a hard [N, T] alignment matrix."""
    durations = np.asarray(durations, np.int64).reshape(-1)
    total = int(durations.sum())
    t = t_frames or total
    out = np.zeros((len(durations), t), np.float32)
    pos = 0
    for i, d in enumerate(durations):
        out[i, pos:min(pos + int(d), t)] = 1.0
        pos += int(d)
    return out
