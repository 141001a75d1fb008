"""Logging (``vispeech_tpu/utils/logging.py``).

- python logging to stderr and ``train.log`` in the run directory;
- TensorBoard scalars, images and audio through tensorboardX where it can
  be imported, else a JSON-lines writer (``events.jsonl``) that records
  every scalar and drops images; audio that tensorboardX cannot encode
  (without soundfile), or that the JSON-lines writer would drop, goes to
  WAV files under ``audio/`` (the JAX package's fallback writer drops it);
- the code's git hash pinned into the run directory.

tensorboardX is imported when a ``TrainLogger`` is made, not with this
module, so its absence costs nothing until then.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np


def get_logger(save_dir: Optional[str] = None,
               name: str = "vispeech_tpu_torch") -> logging.Logger:
    """Stream and (with ``save_dir``) ``train.log`` logger, each handler
    added once."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        log_path = os.path.abspath(os.path.join(save_dir, "train.log"))
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == log_path for h in logger.handlers):
            fh = logging.FileHandler(log_path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def check_git_hash(save_dir: str) -> Optional[str]:
    """Record the code's git hash in ``save_dir/githash``; warn when the run
    directory already holds another."""
    logger = logging.getLogger("vispeech_tpu_torch")
    try:
        cur = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        logger.warning("git hash unavailable; not a git checkout?")
        return None
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur:
            logger.warning("git hash mismatch: run dir has %s, code is %s", saved, cur)
    else:
        with open(path, "w") as f:
            f.write(cur)
    return cur


class _JsonlWriter:
    """Scalars as JSON lines where tensorboardX is unavailable; images and
    audio are dropped."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, global_step=None):
        self._f.write(json.dumps({
            "t": time.time(), "tag": tag, "value": float(value), "step": global_step,
        }) + "\n")
        self._f.flush()

    def add_image(self, *a, **k):
        pass

    def add_audio(self, *a, **k):
        pass

    def close(self):
        self._f.close()

    def flush(self):
        self._f.flush()


class TrainLogger:
    """Scalars, images and audio to TensorBoard.

    ``scalars(step, {...})`` takes the step's metrics (tensors or numbers);
    ``image`` an HWC uint8 or [0, 1] float image; ``audio`` a 1-D waveform
    in [−1, 1].  ``records_media`` is False for the JSON-lines writer,
    which drops images, so a caller need not render them."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        self.writer = SummaryWriter(logdir) if SummaryWriter else _JsonlWriter(logdir)

    @property
    def records_media(self) -> bool:
        return not isinstance(self.writer, _JsonlWriter)

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        for tag, value in metrics.items():
            self.writer.add_scalar(tag, float(value), global_step=step)

    def image(self, step: int, tag: str, image_hwc: np.ndarray) -> None:
        img = np.asarray(image_hwc)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        self.writer.add_image(tag, img, global_step=step, dataformats="HWC")

    def audio(self, step: int, tag: str, wav: np.ndarray, sampling_rate: int) -> None:
        """To TensorBoard; to ``audio/{tag}_{step}.wav`` where tensorboardX
        cannot encode it (it needs soundfile) or is absent (the JSON-lines
        writer would drop it)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        if self.records_media:
            try:
                self.writer.add_audio(tag, wav.reshape(-1, 1), global_step=step,
                                      sample_rate=sampling_rate)
                return
            except ImportError:
                pass
        from scipy.io import wavfile

        audio_dir = os.path.join(self.logdir, "audio")
        os.makedirs(audio_dir, exist_ok=True)
        wavfile.write(os.path.join(audio_dir, f"{tag.replace('/', '_')}_{step}.wav"),
                      sampling_rate, (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16))

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
