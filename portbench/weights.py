"""Seeded weights for the benchmark, made on the device in one draw.

One ``torch.randn`` over every parameter at once, on the run's device from
a generator seeded with the run's seed, then each parameter's slice scaled
or filled by its kind (the reference's ``param_spec``).  The distributions
are the configuration file's ``weights`` block:

* convolutions and linears N(0, gain²/fan_in): unit gain for all but the
  vocoder's last convolution (``post_gain``, so that the audio before tanh
  has a speech-like level) and the prior's projection (``proj_gain``, so
  that the prior's log-scales stay near 0);
* weight-normed convolutions: v ~ N(0, 1) and gains that give each output
  the variance of the input (1 per output channel; √(cout·stride/cin) per
  input channel of a transposed convolution);
* biases N(0, ``bias_std``²), layer norms 1 and 0, speaker embeddings
  N(0, 1), phoneme embeddings N(0, 1/h) (scaled by √h in the model),
  relative tables N(0, 1/d);
* the duration head's output bias ``dur_bias``: the one value chosen for
  its effect, so that predicted durations average a read-speech rate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make_state(spec: List[Tuple[str, Tuple[int, ...], str]], gains: Dict[str, float],
               seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """name → float32 tensor on ``device`` for every entry of ``spec``."""
    shapes = {name: shape for name, shape, _ in spec}
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    state, offset = {}, 0
    with torch.no_grad():
        for name, shape, kind in spec:
            n = math.prod(shape)
            t = flat[offset:offset + n].view(shape)
            offset += n
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
            if kind in ("w", "w_post", "w_proj", "w_dur"):
                gain = {"w": 1.0, "w_post": gains["post_gain"], "w_proj": gains["proj_gain"],
                        "w_dur": gains["dur_gain"]}[kind]
                t.mul_(gain / math.sqrt(fan_in))
            elif kind == "b":
                t.mul_(gains["bias_std"])
            elif kind == "g":
                t.fill_(1.0)
            elif kind.startswith("g_t"):
                stride = int(kind[3:])
                cin, cout = shapes[name.replace("weight_g", "weight_v")][:2]
                t.fill_(math.sqrt(cout * stride / cin))
            elif kind == "one":
                t.fill_(1.0)
            elif kind == "zero":
                t.zero_()
            elif kind in ("rel", "emb_sym"):
                t.mul_(shape[-1] ** -0.5)
            elif kind == "dur_bias":
                t.fill_(gains["dur_bias"])
            elif kind == "emb":
                t.mul_(gains["speaker_std"])
            elif kind != "v":
                raise ValueError(f"unknown parameter kind {kind!r} of {name}")
            state[name] = t
    return state
