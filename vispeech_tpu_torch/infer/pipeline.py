"""TTS serving engine (``vispeech_tpu/infer/pipeline.py``).

Text → phoneme ids padded to a multiple of 32 → a duration-only pass →
frame bucket → ``Synthesizer.infer`` → int16 PCM quantised on the device.
Scalar controls multiply the predictions; per-phoneme arrays replace them.
``synthesize_batch`` groups requests by frame bucket into batch tiers and
runs the plans one after another on the current stream (sequential
dispatch; no side-stream overlap in this version).  ``voice_conversion``
takes a waveform: host linear spectrogram → serving bucket →
``Synthesizer.voice_conversion`` → f32 audio.

One engine call runs at a time: ``synthesize``, ``synthesize_batch`` and
``voice_conversion`` hold the engine's lock, since they share process-wide
state (the TF32 switches ``ServingPolicy.precision`` sets and restores, the
kernels' prepared-weight caches and launch counters, the model's eval mode
that each inference method sets and restores).  The HTTP server calls them
from its coalescer's dispatcher and its worker thread.
"""

from __future__ import annotations

import functools
import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vispeech_tpu_torch.config import Config, load_config
from vispeech_tpu_torch.data.dataset import numpy_spectrogram
from vispeech_tpu_torch.infer.batching import DEFAULT_TIERS, pick_bucket, plan_batches
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.ops.layers import freeze_weight_norm
from vispeech_tpu_torch.ops.policy import (
    ServingPolicy,
    default_serving_policy,
    resolve_device,
)
from vispeech_tpu_torch.text import N_SYMBOLS, cleaned_text_to_sequence, text_to_phones
from vispeech_tpu_torch.utils.jax_weights import load_flax_params
from vispeech_tpu_torch.utils.reference_import import reference_state_dict

Control = Union[None, float, np.ndarray, Sequence[float]]

_PH_PAD = 32
# the checkpoints a run directory may hold, in order of preference: the
# port trainer's own, the JAX trainer's, the reference's generator
CHECKPOINT_FORMATS = (
    ("pt", re.compile(r"^ckpt_(\d+)\.pt$")),
    ("npz", re.compile(r"^ckpt_(\d+)\.npz$")),
    ("pth", re.compile(r"^G_(\d+)\.pth$")),
)


def find_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Tuple[str, str]:
    """(format, path) of the checkpoint to serve: the newest step (or
    ``step``) of the first format in ``CHECKPOINT_FORMATS`` that has one."""
    names = os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    for kind, pattern in CHECKPOINT_FORMATS:
        steps = {int(m.group(1)): m.group(0) for m in map(pattern.match, names) if m}
        if steps and (step is None or step in steps):
            return kind, os.path.join(ckpt_dir, steps[max(steps) if step is None else step])
    raise FileNotFoundError(f"no checkpoint{'' if step is None else f' at step {step}'} "
                            f"in {ckpt_dir} (ckpt_*.pt, ckpt_*.npz or G_*.pth)")


def load_generator_params(path: str) -> Dict[str, np.ndarray]:
    """The generator's flax parameters of a JAX trainer checkpoint
    (``params_g/params/...`` arrays) as a flat ``{"a/b/c": ndarray}``."""
    flat = {}
    with np.load(path) as stored:
        for key in stored.files:
            if key.startswith("params_g/params/"):
                flat[key[len("params_g/params/"):]] = stored[key]
    if not flat:
        raise ValueError(f"checkpoint {path} has no generator params")
    return flat


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _is_array(ctrl) -> bool:
    return isinstance(ctrl, (np.ndarray, list, tuple))


def _one_at_a_time(method):
    """Run ``method`` under the engine's lock (see the module docstring)."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return locked


class TTSEngine:
    """Builds the model once on ``device`` (CUDA unless told ``"cpu"``), then
    synthesizes repeatedly."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 max_phonemes: int = 512, policy: Optional[ServingPolicy] = None,
                 transfer_int16: Optional[bool] = None, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy or default_serving_policy(self.device)
        self.model = Synthesizer.from_config(cfg, N_SYMBOLS, self.policy)
        self.model.load_state_dict(state_dict)
        freeze_weight_norm(self.model.to(self.device).eval())
        self.max_phonemes = max_phonemes
        # int16 PCM is what a client receives; quantise on the device and
        # fetch half the bytes.  'audio' is then pcm / 32767.
        self.transfer_int16 = (self.device.type == "cuda" if transfer_int16 is None
                               else bool(transfer_int16))
        self.spk2id = dict(cfg.data.spk2id)
        self._lock = threading.Lock()

    @classmethod
    def from_flax_params(cls, cfg: Config, flat: Mapping[str, np.ndarray],
                         **kw) -> "TTSEngine":
        model = Synthesizer.from_config(cfg, N_SYMBOLS)
        load_flax_params(model, flat, len(cfg.model.resblock_kernel_sizes))
        return cls(cfg, model.state_dict(), **kw)

    @classmethod
    def from_checkpoint(cls, config_path: str, ckpt_dir: str, step: Optional[int] = None,
                        **kw) -> "TTSEngine":
        """Serve the generator of a run directory: the port trainer's
        ``ckpt_*.pt`` (its ``model_g``), else the JAX trainer's
        ``ckpt_*.npz``, else the reference's ``G_*.pth``; the newest step of
        that format unless ``step`` is given.  A key that the port does not
        have, or a port key left empty, raises."""
        cfg = load_config(config_path)
        kind, path = find_checkpoint(ckpt_dir, step)
        if kind == "npz":
            return cls.from_flax_params(cfg, load_generator_params(path), **kw)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg, ckpt["model_g"] if kind == "pt" else reference_state_dict(ckpt), **kw)

    # ------------------------------------------------------------ helpers

    def _sid(self, speaker) -> int:
        return self.spk2id.get(speaker, 0) if isinstance(speaker, str) else int(speaker)

    def _n_pad(self, n: int) -> int:
        n_pad = min(_round_up(max(n, 1), _PH_PAD), self.max_phonemes)
        if n > n_pad:
            raise ValueError(f"too many phonemes: {n} > {self.max_phonemes}")
        return n_pad

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _predicted_durations(self, ph: np.ndarray, lens: Sequence[int],
                             sids: Sequence[int]) -> np.ndarray:
        pred = self.model.predict_durations(
            self._tensor(ph, torch.long), self._tensor(lens, torch.long),
            self._tensor(sids, torch.long))
        return pred.cpu().numpy()

    def _fetch_audio(self, audio: torch.Tensor):
        """(float32 wav rows, int16 rows or None) on the host."""
        if self.transfer_int16:
            pcm = torch.round(torch.clamp(audio[..., 0], -1.0, 1.0) * 32767.0)
            pcm = pcm.to(torch.int16).cpu().numpy()
            return pcm.astype(np.float32) / 32767.0, pcm
        return audio[..., 0].cpu().numpy(), None

    def _split_control(self, ctrl: Control, n_pad: int, n: int):
        """Array control → (padded [1, n_pad] tensor, None); scalar → (None, scale)."""
        if _is_array(ctrl):
            arr = np.zeros((1, n_pad), np.float32)
            arr[0, :n] = np.asarray(ctrl, np.float32).reshape(-1)[:n]
            return self._tensor(arr), None
        return None, 1.0 if ctrl is None else float(ctrl)

    # ------------------------------------------------------------ main API

    def phonemes(self, text: str) -> List[str]:
        return text_to_phones(text)

    @_one_at_a_time
    def synthesize(self, text: Optional[str] = None,
                   phones: Optional[Sequence[str]] = None,
                   speaker: Union[int, str] = 0, noise_scale: float = 0.667,
                   duration_control: Control = None, pitch_control: Control = None,
                   energy_control: Control = None, seed: int = 0) -> Dict[str, object]:
        """→ {'audio' [samples] f32, 'sampling_rate', 'phones', and per phoneme
        'duration', 'f0', 'energy'} (+ 'audio_int16' with transfer_int16)."""
        if phones is None:
            if text is None:
                raise ValueError("need text or phones")
            phones = self.phonemes(text)
        ids = cleaned_text_to_sequence(list(phones))
        n = len(ids)
        n_pad = self._n_pad(n)
        ph = np.zeros((1, n_pad), np.int64)
        ph[0, :n] = ids
        sid = self._sid(speaker)

        with self.policy.precision():
            if _is_array(duration_control):
                dur = np.zeros((1, n_pad), np.float32)
                dur[0, :n] = np.asarray(duration_control, np.float32).reshape(-1)[:n]
            else:
                scale = 1.0 if duration_control is None else float(duration_control)
                dur = np.ceil(np.maximum(self._predicted_durations(ph, [n], [sid]) * scale,
                                         0.0)).astype(np.float32)
                dur[0, n:] = 0
            t_frames = pick_bucket(max(int(dur.sum()), 1))
            pitch_arr, pitch_scale = self._split_control(pitch_control, n_pad, n)
            energy_arr, energy_scale = self._split_control(energy_control, n_pad, n)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            audio, frame_mask, _, out_dur, f0, energy = self.model.infer(
                self._tensor(ph, torch.long), self._tensor([n], torch.long), t_frames,
                sid=self._tensor([sid], torch.long), noise_scale=noise_scale,
                duration_control=self._tensor(dur),
                pitch_control=pitch_arr if pitch_arr is not None else pitch_scale,
                energy_control=energy_arr if energy_arr is not None else energy_scale,
                generator=gen)
            n_samples = int(frame_mask.sum().item()) * self.cfg.data.hop_length
            wav, pcm = self._fetch_audio(audio)
        out = {
            "audio": wav[0, :n_samples],
            "sampling_rate": self.cfg.data.sampling_rate,
            "phones": list(phones),
            "duration": out_dur[0, :n].cpu().numpy(),
            "f0": f0[0, :n].cpu().numpy(),
            "energy": energy[0, :n].cpu().numpy(),
        }
        if pcm is not None:
            out["audio_int16"] = pcm[0, :n_samples]
        return out

    @_one_at_a_time
    def synthesize_batch(self, texts: Optional[Sequence[str]] = None,
                         phones_list: Optional[Sequence[Sequence[str]]] = None,
                         speakers: Union[int, str, Sequence] = 0,
                         noise_scale: float = 0.667, seed: int = 0,
                         tiers: Optional[Sequence[int]] = None) -> List[Dict[str, object]]:
        """Bulk synthesis: predicted durations per request, then one dispatch
        per (bucket, tier) plan.  Order-preserving; same fields as
        ``synthesize``.  The prior noise for all plans comes from one
        generator seeded with ``seed``, drawn in plan order."""
        if phones_list is None:
            if texts is None:
                raise ValueError("need texts or phones_list")
            phones_list = [self.phonemes(t) for t in texts]
        R = len(phones_list)
        if not isinstance(speakers, (list, tuple, np.ndarray)):
            speakers = [speakers] * R
        sids = [self._sid(s) for s in speakers]
        ids_list = [cleaned_text_to_sequence(list(p)) for p in phones_list]
        n_list = [len(ids) for ids in ids_list]
        hop = self.cfg.data.hop_length
        results: List[Optional[Dict[str, object]]] = [None] * R

        with self.policy.precision():
            durs: List[Optional[np.ndarray]] = [None] * R
            by_npad: Dict[int, List[int]] = {}
            for i, n in enumerate(n_list):
                by_npad.setdefault(self._n_pad(n), []).append(i)
            for n_pad, idxs in by_npad.items():
                ph = np.zeros((len(idxs), n_pad), np.int64)
                for r, i in enumerate(idxs):
                    ph[r, :n_list[i]] = ids_list[i]
                pred = self._predicted_durations(ph, [n_list[i] for i in idxs],
                                                 [sids[i] for i in idxs])
                for r, i in enumerate(idxs):
                    d = np.ceil(np.maximum(pred[r], 0.0)).astype(np.float32)
                    d[n_list[i]:] = 0
                    durs[i] = d
            totals = [max(int(d.sum()), 1) for d in durs]

            gen = torch.Generator(device=self.device).manual_seed(seed)
            for plan in plan_batches(totals, tiers=tiers or DEFAULT_TIERS):
                n_pad = self._n_pad(max(n_list[i] for i in plan.indices))
                B = plan.tier
                ph = np.zeros((B, n_pad), np.int64)
                lens = np.ones((B,), np.int64)
                dur = np.zeros((B, n_pad), np.float32)
                sid = np.zeros((B,), np.int64)
                for r, i in enumerate(plan.indices):
                    ph[r, :n_list[i]] = ids_list[i]
                    lens[r] = n_list[i]
                    dur[r, :len(durs[i])] = durs[i][:n_pad]
                    sid[r] = sids[i]
                audio, _, _, out_dur, f0, energy = self.model.infer(
                    self._tensor(ph, torch.long), self._tensor(lens, torch.long),
                    plan.bucket, sid=self._tensor(sid, torch.long),
                    noise_scale=noise_scale, duration_control=self._tensor(dur),
                    generator=gen)
                wav, pcm = self._fetch_audio(audio)
                out_dur, f0, energy = (t.cpu().numpy() for t in (out_dur, f0, energy))
                for r, i in enumerate(plan.indices):
                    n, n_samples = n_list[i], totals[i] * hop
                    results[i] = {
                        "audio": wav[r, :n_samples],
                        "sampling_rate": self.cfg.data.sampling_rate,
                        "phones": list(phones_list[i]),
                        "duration": out_dur[r, :n],
                        "f0": f0[r, :n],
                        "energy": energy[r, :n],
                    }
                    if pcm is not None:
                        results[i]["audio_int16"] = pcm[r, :n_samples]
        return results

    # ------------------------------------------------------ voice conversion

    @_one_at_a_time
    def voice_conversion(self, wav: np.ndarray, speaker_src: Union[int, str],
                         speaker_tgt: Union[int, str],
                         eps: Optional[np.ndarray] = None) -> Dict[str, object]:
        """Any-to-any conversion through the shared flow prior
        (``vispeech_tpu/infer/pipeline.py:392``): ``wav`` [samples] → linear
        spectrogram on the host, padded to the serving bucket →
        ``Synthesizer.voice_conversion`` on the engine's device.  The
        posterior noise comes from a generator seeded with 0 (as the JAX
        engine draws it from a fixed key), or ``eps`` [1, bucket, inter]
        injects it.  → {'audio' f32 [frames·hop], 'sampling_rate'}."""
        d = self.cfg.data
        spec = numpy_spectrogram(np.asarray(wav, np.float32), d.filter_length, d.hop_length,
                                 d.win_length)
        t = spec.shape[0]
        spec_pad = np.zeros((1, pick_bucket(t), spec.shape[1]), np.float32)
        spec_pad[0, :t] = spec
        with self.policy.precision():
            gen = torch.Generator(device=self.device).manual_seed(0)
            audio, _, _ = self.model.voice_conversion(
                self._tensor(spec_pad), self._tensor([t], torch.long),
                self._tensor([self._sid(speaker_src)], torch.long),
                self._tensor([self._sid(speaker_tgt)], torch.long),
                eps=None if eps is None else self._tensor(eps), generator=gen)
            wav_out = audio[0, :t * d.hop_length, 0].cpu().numpy()
        return {"audio": wav_out, "sampling_rate": d.sampling_rate}
