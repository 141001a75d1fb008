"""The comparison that decides a run's ``correct``.

After the window closes and the program's state is freed, the plain
reference (``references/<name>.py``) is run over what the program served:

* every finished request's text side, batched: its durations, f0 and
  energy.  A duration is an integer the program chose by a ceiling, so it
  is judged as a served token is: ``dur_gap`` is how far (in frames) the
  reference's e^logw − 1 lies outside the interval (d − 1, d] that the
  served duration d implies, 0 where the two agree;
* a sample of the requests, drawn from the seed with the longest in it,
  through the frame prior, the flow in reverse and the vocoder to int16
  PCM, teacher-forced with the served durations.

The reference works out again what the engine derived on its way: the
frame bucket, the (bucket, tier) plans of a ``synthesize_batch`` call, the
phoneme padding of each plan (the energy head sees the padding), and the
prior noise, which the engine draws from a generator seeded with the
call's seed, one [tier, bucket, inter] draw a plan in plan order.  The
serving tables below are copies of the engine's policy
(``infer/batching.py``, ``infer/pipeline.py``): a change to how the engine
plans a call or draws its noise has to be made here too, or ``pcm_err``
reads the change as a fault.

Numbers, each against the cell's limit (``cells/<workload>.json``):
``dur_gap`` frames; ``f0_err`` and ``energy_err``, the largest error of a
request over the largest magnitude of its reference; ``pcm_err``, the
largest sample error in full-scale units (1 = 32767).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SERVING_BUCKETS = (64, 128, 192, 256, 320, 384, 448, 512, 576, 640, 704, 768,
                   896, 1024, 1152, 1280, 1400)
DEFAULT_TIERS = (16, 8, 4, 2, 1)
PH_PAD = 32
MAX_PHONEMES = 512
TEXT_BATCH = 64            # rows of one batched reference text-side pass
NUMBERS = ("dur_gap", "f0_err", "energy_err", "pcm_err")


def pick_bucket(n_frames: int) -> int:
    for b in SERVING_BUCKETS:
        if n_frames <= b:
            return b
    return ((n_frames + 255) // 256) * 256


def phoneme_pad(n: int) -> int:
    return min(((max(n, 1) + PH_PAD - 1) // PH_PAD) * PH_PAD, MAX_PHONEMES)


def plan_batches(frame_counts: Sequence[int], tiers: Sequence[int] = DEFAULT_TIERS):
    """[(bucket, tier, indices)]: each bucket's queue cut into full batches
    of the largest tier that fits, the rest in the smallest tier covering it."""
    tiers = sorted(tiers, reverse=True)
    by_bucket: Dict[int, List[int]] = {}
    for i, f in enumerate(frame_counts):
        by_bucket.setdefault(pick_bucket(int(f)), []).append(i)
    plans = []
    for b in sorted(by_bucket):
        idxs, pos = by_bucket[b], 0
        while pos < len(idxs):
            rem = len(idxs) - pos
            tier = next((t for t in tiers if t <= rem), tiers[-1])
            take = min(tier, rem)
            plans.append((b, tier, tuple(idxs[pos:pos + take])))
            pos += take
    return plans


@dataclass
class Served:
    """One request as the program answered it."""

    ids: np.ndarray            # phoneme ids [n]
    speaker: int
    duration: np.ndarray       # served frames per phoneme [n]
    f0: np.ndarray
    energy: np.ndarray
    pcm: np.ndarray            # int16 [frames·hop]


@dataclass
class EngineCall:
    """One ``synthesize_batch`` call: its requests in order, its seed and
    noise scale."""

    requests: List[int]
    seed: int = 0
    noise_scale: float = 0.667
    start: float = 0.0         # host clock at the call's start
    # filled by ``derive``: request → (bucket, phoneme padding, eps row)
    derived: Dict[int, tuple] = field(default_factory=dict)


def derive(call: EngineCall, served: Dict[int, Served], inter: int,
           device: torch.device, keep: Optional[set] = None) -> None:
    """The bucket, the phoneme padding and the prior noise of each request
    of ``call``, as the engine derived them; noise rows are kept for the
    requests in ``keep`` (all when None)."""
    totals = [max(int(served[r].duration.sum()), 1) for r in call.requests]
    gen = torch.Generator(device=device)
    gen.manual_seed(call.seed)
    for bucket, tier, idxs in plan_batches(totals):
        eps = torch.randn((tier, bucket, inter), generator=gen, device=device)
        pad = phoneme_pad(max(len(served[call.requests[i]].ids) for i in idxs))
        for row, i in enumerate(idxs):
            r = call.requests[i]
            want = keep is None or r in keep
            call.derived[r] = (bucket, pad, eps[row:row + 1].clone() if want else None)


def _text_side(ref, reqs: List[int], served, pads, keep: set, device):
    """Batched reference text side: request → (w, f0, energy, x [1, n_pad,
    h] for the requests in ``keep``, else None)."""
    out = {}
    by_pad: Dict[int, List[int]] = {}
    for r in reqs:
        by_pad.setdefault(pads[r], []).append(r)
    for pad, rs in sorted(by_pad.items()):
        for s in range(0, len(rs), TEXT_BATCH):
            chunk = rs[s:s + TEXT_BATCH]
            ph = torch.zeros(len(chunk), pad, dtype=torch.long)
            for row, r in enumerate(chunk):
                ph[row, :len(served[r].ids)] = torch.as_tensor(served[r].ids)
            lengths = torch.tensor([len(served[r].ids) for r in chunk])
            sid = torch.tensor([served[r].speaker for r in chunk])
            w, f0, energy, x = ref.text_side(ph.to(device), lengths.to(device), sid.to(device))
            for row, r in enumerate(chunk):
                n = len(served[r].ids)
                out[r] = (w[row, :n].double().cpu().numpy(), f0[row, :n].double().cpu().numpy(),
                          energy[row, :n].double().cpu().numpy(),
                          x[row:row + 1].clone() if r in keep else None)
    return out


def dur_gap(w: np.ndarray, d: np.ndarray) -> float:
    """Largest distance of the reference's w outside (d − 1, d] (d = 0:
    (−inf, 0]), over the phonemes."""
    lo = np.where(d > 0, d - 1.0, -np.inf)
    return float(np.max(np.maximum.reduce([np.zeros_like(w), w - d, lo - w]), initial=0.0))


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want), initial=0.0) / max(np.max(np.abs(want),
                                                                       initial=0.0), 1e-6))


def compare(ref, served: Dict[int, Served], calls: List[EngineCall], sample: List[int],
            inter: int, device: torch.device) -> Dict[str, float]:
    """The four numbers of the module docstring."""
    keep = set(sample)
    calls = [c for c in calls if all(r in served for r in c.requests)]
    for call in calls:
        derive(call, served, inter, device, keep)
    reqs = [r for c in calls for r in c.requests]
    pads = {r: c.derived[r][1] for c in calls for r in c.requests}
    text = _text_side(ref, reqs, served, pads, keep, device)
    numbers = {"dur_gap": 0.0, "f0_err": 0.0, "energy_err": 0.0, "pcm_err": 0.0}
    for r in reqs:
        w, f0, energy, _ = text[r]
        s = served[r]
        numbers["dur_gap"] = max(numbers["dur_gap"], dur_gap(w, s.duration.astype(np.float64)))
        numbers["f0_err"] = max(numbers["f0_err"], rel_err(s.f0.astype(np.float64), f0))
        numbers["energy_err"] = max(numbers["energy_err"],
                                    rel_err(s.energy.astype(np.float64), energy))
    by_req = {r: c for c in calls for r in c.requests}
    for r in (r for r in sample if r in by_req):
        s, call = served[r], by_req[r]
        bucket, _, eps = call.derived[r]
        x = text[r][3]
        dur = torch.as_tensor(s.duration.astype(np.int64), device=device)
        z = ref.frames(x, dur, bucket, torch.tensor([s.speaker], device=device), eps,
                       call.noise_scale)
        audio = ref.vocode(z, torch.tensor([s.speaker], device=device))
        n = int(s.duration.sum()) * (len(audio) // bucket)
        pcm = ref.pcm(audio[:n]).cpu().numpy().astype(np.int64)
        if len(s.pcm) != n:
            numbers["pcm_err"] = math.inf
            continue
        err = np.max(np.abs(pcm - s.pcm.astype(np.int64)), initial=0) / 32767.0
        numbers["pcm_err"] = max(numbers["pcm_err"], float(err))
    return numbers


def emulate(ref, requests: Dict[int, tuple], calls: List[EngineCall], sample: List[int],
            inter: int, device: torch.device) -> Dict[int, Served]:
    """The reference put in the program's place: what ``ref`` serves for
    ``requests`` (id → (phoneme ids, speaker)) under the engine calls
    ``calls``, the PCM for ``sample`` only; as the engine derives them,
    durations first, then each plan's padding and noise."""
    served = {r: Served(np.asarray(ids), spk, None, None, None, None)
              for r, (ids, spk) in requests.items()}
    reqs = [r for c in calls for r in c.requests]
    first = _text_side(ref, reqs, served, {r: phoneme_pad(len(served[r].ids)) for r in reqs},
                       set(), device)
    for r in reqs:
        served[r].duration = np.maximum(np.ceil(first[r][0]), 0.0)
    keep = set(sample)
    for call in calls:
        derive(call, served, inter, device, keep)
    pads = {r: c.derived[r][1] for c in calls for r in c.requests}
    text = _text_side(ref, reqs, served, pads, keep, device)
    by_req = {r: c for c in calls for r in c.requests}
    for r in reqs:
        s = served[r]
        s.f0, s.energy = text[r][1], text[r][2]
        if r in keep:
            call = by_req[r]
            bucket, _, eps = call.derived[r]
            sid = torch.tensor([s.speaker], device=device)
            z = ref.frames(text[r][3], torch.as_tensor(s.duration.astype(np.int64), device=device),
                           bucket, sid, eps, call.noise_scale)
            audio = ref.vocode(z, sid)
            n = int(s.duration.sum()) * (len(audio) // bucket)
            s.pcm = ref.pcm(audio[:n]).cpu().numpy()
    for call in calls:
        call.derived.clear()
    return served
