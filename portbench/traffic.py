"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``)
and makes its requests from the seed.

Every seed gets the same amount of work in another order: the lengths of a
call are the ``call_size`` quantiles of the mix's length distribution,
permuted by the seed; what the seed draws freely are the phonemes and the
speakers.  A request is phoneme symbols (uniform over the configuration's
symbol set, the pad excluded) and a speaker id.

The one mode, ``batch_calls``: calls of ``call_size`` sentences back to
back, each call one speaker.  Lengths are seconds of audio, turned into
phoneme counts at the configuration's ``ms_per_token``.

Length distributions (``length_s``): ``lognormal`` (``median``,
``sigma``), ``uniform`` and ``triangular`` (the one with a corpus's
``min``, ``mean`` and ``max``: its mode is 3·mean − min − max), each
clipped to ``[min, max]``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Sequence


@dataclass
class Request:
    phones: List[str]
    speaker: int


def _quantiles(spec: Dict, n: int) -> List[float]:
    """The ``n`` mid-quantiles (i + ½)/n of the length distribution, seconds."""
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        nd = NormalDist(math.log(spec["median"]), spec["sigma"])
        vals = [math.exp(nd.inv_cdf(q)) for q in qs]
    elif spec["dist"] == "uniform":
        vals = [spec["min"] + q * (spec["max"] - spec["min"]) for q in qs]
    elif spec["dist"] == "triangular":
        a, b = spec["min"], spec["max"]
        c = 3.0 * spec["mean"] - a - b
        if not a <= c <= b:
            raise ValueError(f"no triangular distribution on [{a}, {b}] has mean {spec['mean']}")
        fc = (c - a) / (b - a)
        vals = [a + math.sqrt(q * (b - a) * (c - a)) if q < fc
                else b - math.sqrt((1.0 - q) * (b - a) * (b - c)) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(max(v, spec["min"]), spec["max"]) for v in vals]


def tokens(seconds: float, ms_per_token: float) -> int:
    return max(1, round(seconds * 1000.0 / ms_per_token))


def _stream(seed: int, *salt: int) -> random.Random:
    return random.Random(f"{seed}:" + ":".join(map(str, salt)))


def _phones(rng: random.Random, n: int, symbols: Sequence[str]) -> List[str]:
    return [symbols[rng.randrange(1, len(symbols))] for _ in range(n)]


def length_range(traffic: Dict, ms_per_token: float) -> range:
    """The phoneme counts the mix can produce."""
    spec = traffic["length_s"]
    return range(tokens(spec["min"], ms_per_token), tokens(spec["max"], ms_per_token) + 1)


def batch_call(traffic: Dict, cfg: Dict, seed: int, k: int) -> List[Request]:
    """Call ``k`` of a ``batch_calls`` mix (k < 0: the warm-up's calls)."""
    rng = _stream(seed, k)
    n = traffic["call_size"]
    lengths = _quantiles(traffic["length_s"], n)
    rng.shuffle(lengths)
    speaker = rng.randrange(cfg["data"]["n_speakers"])
    ms = cfg["weights"]["ms_per_token"]
    return [Request(_phones(rng, tokens(s, ms), cfg["symbols"]), speaker) for s in lengths]

