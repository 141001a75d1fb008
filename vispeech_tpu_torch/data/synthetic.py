"""Deterministic synthetic speech-like corpus (``vispeech_tpu/data/synthetic.py``).

With no corpus in the repository, the trainer runs on data whose
text → audio mapping is exactly learnable: each utterance is a harmonic
stack driven by per-phoneme F0 and amplitude with fixed durations, written
through the real filelist contract (``spk|id|phones|durs|f0|energy``) so
the whole input pipeline runs.  Every quantity is a pure function of
(seed, utterance index): the corpus regenerates bit for bit anywhere.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# voiced pinyin finals (in the 519-symbol vocab) with a deterministic base F0
# each — phoneme identity fully determines pitch, so the pitch/duration heads
# have a learnable target, and the decoder a stable timbre per symbol.
PHONE_POOL: Tuple[Tuple[str, float], ...] = (
    ("a1", 220.0),
    ("o2", 175.0),
    ("e3", 139.0),
    ("i1", 262.0),
    ("u2", 196.0),
    ("ai4", 165.0),
    ("ang1", 110.0),
    ("en2", 247.0),
)
_N_HARMONICS = 4
_HARMONIC_DECAY = 0.55


def synth_utterance(
    seed: int,
    n_phones: int,
    sr: int,
    hop: int,
    dur_range: Tuple[int, int] = (4, 10),
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One deterministic utterance.

    Returns (phones, durations[frames], f0[Hz], energy, wav[float ±1]).
    The waveform is a phase-continuous harmonic stack: per phoneme *p* with
    base frequency F(p), ``Σ_h decay^h · sin(2π·h·F·t)`` scaled by a
    per-phoneme amplitude; ``energy`` is derived FROM the rendered audio
    (per-phoneme RMS), so the teacher-forced energy input is physically
    consistent with the target waveform.
    """
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(PHONE_POOL), size=n_phones)
    phones = [PHONE_POOL[i][0] for i in idx]
    f0 = np.asarray([PHONE_POOL[i][1] for i in idx], np.float32)
    # small deterministic vibrato per utterance keeps utterances distinct
    f0 = f0 * (1.0 + 0.03 * rng.randn(n_phones).astype(np.float32))
    durs = rng.randint(dur_range[0], dur_range[1] + 1, size=n_phones).astype(np.int32)
    amps = rng.uniform(0.15, 0.45, size=n_phones).astype(np.float32)

    total = int(durs.sum()) * hop
    wav = np.zeros(total, np.float32)
    phase = np.zeros(_N_HARMONICS, np.float64)
    pos = 0
    for p in range(n_phones):
        n = int(durs[p]) * hop
        t = np.arange(n, dtype=np.float64) / sr
        seg = np.zeros(n, np.float64)
        for h in range(_N_HARMONICS):
            w = 2.0 * np.pi * (h + 1) * float(f0[p])
            seg += (_HARMONIC_DECAY ** h) * np.sin(w * t + phase[h])
            phase[h] = (phase[h] + w * n / sr) % (2.0 * np.pi)
        # short raised-cosine fade at segment edges softens transitions
        fade = min(hop // 2, n // 4)
        if fade > 0:
            ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, fade))
            seg[:fade] *= ramp
            seg[-fade:] *= ramp[::-1]
        wav[pos : pos + n] = (amps[p] * seg).astype(np.float32)
        pos += n
    wav += 1e-4 * rng.randn(total).astype(np.float32)

    # per-phoneme energy from the audio itself (monotone in amplitude, the
    # role the reference's per-phoneme STFT-L2 average plays, f0energy.py:84)
    energy = np.empty(n_phones, np.float32)
    pos = 0
    for p in range(n_phones):
        n = int(durs[p]) * hop
        rms = float(np.sqrt(np.mean(np.square(wav[pos : pos + n])) + 1e-12))
        energy[p] = 60.0 + 36.0 * np.log10(rms + 1e-5)  # lands ~30-90
        pos += n
    return phones, durs, f0, energy, wav


def write_synthetic_dataset(
    root: str,
    sr: int,
    hop: int,
    n_utts: int = 8,
    n_phones: int = 12,
    dur_range: Tuple[int, int] = (4, 10),
    seed: int = 0,
    speakers: Sequence[str] = ("spk0", "spk1"),
    val_utts: int = 1,
    n_phones_choices: Optional[Sequence[int]] = None,
) -> Tuple[str, str, str]:
    """Write wavs + filelists under `root`.

    Returns (train_list, val_list, data_root).  The val list reuses the
    first training utterance (overfit validation — the reference's evaluate
    also synthesizes training-distribution text, train.py:272-339).

    `n_phones_choices` produces a mixed-length corpus: utterance *i* gets
    ``n_phones_choices[i % len]`` phonemes (deterministic), so frame lengths
    spread across the production bucket range — the regime the Trainer's
    bucketed batching actually faces (reference data_utils.py:219-318).
    """
    from scipy.io import wavfile

    data_root = os.path.join(root, "dataset")
    lines = []
    for i in range(n_utts):
        spk = speakers[i % len(speakers)]
        utt = f"u{i:03d}"
        n_ph = (n_phones_choices[i % len(n_phones_choices)]
                if n_phones_choices else n_phones)
        phones, durs, f0, energy, wav = synth_utterance(
            seed * 10_007 + i, n_ph, sr, hop, dur_range
        )
        os.makedirs(os.path.join(data_root, spk), exist_ok=True)
        wavfile.write(
            os.path.join(data_root, spk, f"{utt}.wav"),
            sr,
            (np.clip(wav, -1, 1) * 32767).astype(np.int16),
        )
        lines.append(
            "|".join(
                [
                    spk,
                    utt,
                    " ".join(phones),
                    " ".join(str(int(d)) for d in durs),
                    " ".join(f"{v:.2f}" for v in f0),
                    " ".join(f"{v:.2f}" for v in energy),
                ]
            )
        )
    train_list = os.path.join(root, "train.list")
    val_list = os.path.join(root, "val.list")
    with open(train_list, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(val_list, "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:val_utts]) + "\n")
    return train_list, val_list, data_root
