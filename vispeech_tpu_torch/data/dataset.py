"""Filelist dataset, length-bucketed batching and prefetch
(``vispeech_tpu/data/dataset.py``).

* filelist line ``spk|id|phones|durations|f0|energy``, wavs at
  ``{data_root}/{spk}/{id}.wav`` (16-bit PCM);
* utterances longer than 1400 frames are dropped;
* batches pad frames to a bucket bound and phonemes to one budget per
  bucket, so each bucket has one batch shape;
* epoch-seeded shuffling and rank-strided, wrap-to-multiple batches, as the
  reference's DistributedBucketSampler;
* device DSP (the default): the batch carries int16 samples and no
  spectrogram; the train step computes it on the device.

``data_loader`` collates on a background thread into pinned memory;
``device_batches`` copies each batch to the device with ``non_blocking``
one batch ahead, so the copy overlaps the running step.
"""

from __future__ import annotations

import os
import queue
import threading
from bisect import bisect_left
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vispeech_tpu_torch.config import DataConfig
from vispeech_tpu_torch.dsp.stft import dft_matrix
from vispeech_tpu_torch.text import cleaned_text_to_sequence

MAX_FRAMES = 1400
DEFAULT_BUCKETS = (64, 128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280, 1400)
PHONEME_PAD_MULTIPLE = 32


@dataclass
class Utterance:
    wav_path: str
    speaker: str
    utt_id: str
    sid: int
    phonemes: np.ndarray  # [N] int32
    duration: np.ndarray  # [N] int32
    f0: np.ndarray        # [N] float32
    energy: np.ndarray    # [N] float32
    n_frames: int


def numpy_spectrogram(audio: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Host linear spectrogram with ``dsp.spectrogram``'s semantics → [T, bins]."""
    pad = (n_fft - hop) // 2
    y = np.pad(audio.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = y[idx] @ dft_matrix(n_fft, win).astype(np.float64)
    n_bins = n_fft // 2 + 1
    re, im = spec[:, :n_bins], spec[:, n_bins:]
    return np.sqrt(re * re + im * im + 1e-6).astype(np.float32)


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return data, sr


class FilelistDataset:
    """Parses the filelist; loads each utterance's audio on demand."""

    def __init__(self, filelist_path: str, cfg: DataConfig, data_root: str = "dataset",
                 max_frames: int = MAX_FRAMES):
        self.cfg = cfg
        self.data_root = data_root
        spk2id = dict(cfg.spk2id)
        self.utterances: List[Utterance] = []
        with open(filelist_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) != 6:
                    continue
                spk, utt_id, phones, durs, f0, energy = parts
                duration = np.array([int(i) for i in durs.split(" ")], np.int32)
                n_frames = int(duration.sum())
                if n_frames > max_frames:
                    continue
                self.utterances.append(Utterance(
                    wav_path=os.path.join(data_root, spk, f"{utt_id}.wav"), speaker=spk,
                    utt_id=utt_id, sid=spk2id.get(spk, 0),
                    phonemes=np.array(cleaned_text_to_sequence(phones.split(" ")), np.int32),
                    duration=duration,
                    f0=np.array([float(i) for i in f0.split(" ")], np.float32),
                    energy=np.array([float(i) for i in energy.split(" ")], np.float32),
                    n_frames=n_frames))

    def __len__(self) -> int:
        return len(self.utterances)

    @property
    def lengths(self) -> List[int]:
        return [u.n_frames for u in self.utterances]

    def _pcm(self, utt: Utterance) -> np.ndarray:
        data, sr = load_wav(utt.wav_path)
        if sr != self.cfg.sampling_rate:
            raise ValueError(f"{utt.wav_path}: {sr} Hz != {self.cfg.sampling_rate}")
        if data.dtype != np.int16:
            raise ValueError(f"{utt.wav_path}: 16-bit PCM wavs only, got {data.dtype}")
        n = utt.n_frames * self.cfg.hop_length
        # the reference's ±2-frame tolerance between audio and durations
        if abs(len(data) - n) >= 2 * self.cfg.hop_length:
            raise ValueError(f"{utt.wav_path}: {len(data)} samples for {utt.n_frames} frames")
        data = np.asarray(data[:n], np.int16)
        return np.pad(data, (0, n - len(data))) if len(data) < n else data

    def load_wav_int16(self, utt: Utterance) -> np.ndarray:
        """Samples cropped or padded to exactly Σdur·hop."""
        return self._pcm(utt)

    def load_audio(self, utt: Utterance) -> Tuple[np.ndarray, np.ndarray]:
        """(spec [Σdur, bins], wav [Σdur·hop] in [−1, 1]) on the host."""
        audio = self._pcm(utt).astype(np.float32) / self.cfg.max_wav_value
        c = self.cfg
        spec = numpy_spectrogram(audio, c.filter_length, c.hop_length, c.win_length)
        return spec[:utt.n_frames], audio


class BucketSampler:
    """Length-bucketed, epoch-seeded, rank-strided batch sampler."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 1234):
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.bucket_indices: List[List[int]] = [[] for _ in self.buckets]
        for i, length in enumerate(lengths):
            b = bisect_left(self.buckets, length)
            if b < len(self.buckets):
                self.bucket_indices[b].append(i)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        """(bucket id, indices) batches of this rank."""
        g = np.random.RandomState(self.seed + self.epoch)
        per_step = self.batch_size * self.num_replicas
        batches = []
        for b, idxs in enumerate(self.bucket_indices):
            if not idxs:
                continue
            idxs = list(idxs)
            if self.shuffle:
                idxs = [idxs[i] for i in g.permutation(len(idxs))]
            idxs = idxs + idxs[:(-len(idxs)) % per_step]
            mine = idxs[self.rank::self.num_replicas]
            for s in range(0, len(mine), self.batch_size):
                batches.append((b, mine[s:s + self.batch_size]))
        if self.shuffle:
            batches = [batches[i] for i in g.permutation(len(batches))]
        return iter(batches)

    def __len__(self) -> int:
        per_step = self.batch_size * self.num_replicas
        return sum((len(i) + (-len(i)) % per_step) // per_step for i in self.bucket_indices if i)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_phoneme_budgets(dataset: FilelistDataset, sampler: BucketSampler,
                           phoneme_pad_multiple: int = PHONEME_PAD_MULTIPLE) -> dict:
    """Bucket id → the phoneme pad of every batch it serves."""
    return {b: _round_up(max(len(dataset.utterances[i].phonemes) for i in idxs),
                         phoneme_pad_multiple)
            for b, idxs in enumerate(sampler.bucket_indices) if idxs}


def collate(dataset: FilelistDataset, indices: Sequence[int], frame_budget: int,
            phoneme_pad_multiple: int = PHONEME_PAD_MULTIPLE,
            phoneme_budget: Optional[int] = None, device_dsp: bool = True) -> dict:
    """One padded batch of numpy arrays (the train step's batch keys);
    ``spec`` is None and ``wav`` int16 under device DSP."""
    cfg = dataset.cfg
    utts = [dataset.utterances[i] for i in indices]
    B = len(utts)
    n_ph = _round_up(max(len(u.phonemes) for u in utts), phoneme_pad_multiple)
    if phoneme_budget is not None:
        n_ph = max(n_ph, phoneme_budget)
    T, hop = frame_budget, cfg.hop_length
    out = dict(
        phonemes=np.zeros((B, n_ph), np.int64), phoneme_lengths=np.zeros(B, np.int64),
        f0=np.zeros((B, n_ph), np.float32), energy=np.zeros((B, n_ph), np.float32),
        duration=np.zeros((B, n_ph), np.int64),
        spec=None if device_dsp else np.zeros((B, T, cfg.spec_channels), np.float32),
        spec_lengths=np.zeros(B, np.int64),
        wav=np.zeros((B, T * hop, 1), np.int16 if device_dsp else np.float32),
        wav_lengths=np.zeros(B, np.int64), sid=np.zeros(B, np.int64))
    for i, u in enumerate(utts):
        n, t = len(u.phonemes), u.n_frames
        out["phonemes"][i, :n] = u.phonemes
        out["f0"][i, :n] = u.f0
        out["energy"][i, :n] = u.energy
        out["duration"][i, :n] = u.duration
        out["phoneme_lengths"][i] = n
        if device_dsp:
            out["wav"][i, :t * hop, 0] = dataset.load_wav_int16(u)
        else:
            s, a = dataset.load_audio(u)
            out["spec"][i, :t] = s
            out["wav"][i, :t * hop, 0] = a
        out["spec_lengths"][i] = t
        out["wav_lengths"][i] = t * hop
        out["sid"][i] = u.sid
    return out


def _pinned(batch: dict) -> dict:
    pin = torch.cuda.is_available()
    return {k: None if v is None else (torch.from_numpy(v).pin_memory() if pin
                                       else torch.from_numpy(v))
            for k, v in batch.items()}


LOADER_THREAD = "vispeech-data-loader"


def data_loader(dataset: FilelistDataset, sampler: BucketSampler, epoch: int,
                prefetch: int = 4, phoneme_budgets: Optional[dict] = None,
                device_dsp: bool = True) -> Iterator[dict]:
    """Batches of host tensors (pinned when a GPU is present), collated on
    a background thread named ``LOADER_THREAD``; a failure there is raised
    here.  Closing the generator early (a consumer that stops, as the
    trainer does at ``max_steps``) stops the thread: it checks a stop event
    between batches and while it waits on the full queue."""
    sampler.set_epoch(epoch)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    failure: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for bucket_id, indices in sampler:
                if stop.is_set() or not put(_pinned(collate(
                        dataset, indices, sampler.buckets[bucket_id],
                        phoneme_budget=(phoneme_budgets or {}).get(bucket_id),
                        device_dsp=device_dsp))):
                    return
        except BaseException as e:  # re-raised on the consumer's thread
            failure.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, name=LOADER_THREAD, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        while thread.is_alive():   # a worker blocked on the full queue sees the event
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(0.05)


def device_batches(batches: Iterator[dict], device: torch.device) -> Iterator[dict]:
    """Each host batch copied to ``device`` with ``non_blocking``, one batch
    ahead of the consumer: batch k+1's copy is queued before batch k is
    handed out, so it overlaps step k."""
    def to_dev(b):
        return {k: None if v is None else v.to(device, non_blocking=True) for k, v in b.items()}

    ahead = None
    for b in batches:
        nxt = to_dev(b)
        if ahead is not None:
            yield ahead
        ahead = nxt
    if ahead is not None:
        yield ahead
