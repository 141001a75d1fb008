"""Shared pieces of the benchmark's own tests: the tiny configuration and
a small mix that runs the harness end to end on the CPU."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

BULK = {"mode": "batch_calls", "call_size": 6,
        "length_s": {"dist": "lognormal", "median": 0.3, "sigma": 0.4, "min": 0.2, "max": 0.5},
        "tiers": [16, 8, 4, 2, 1], "noise_scale": 0.667}


@pytest.fixture
def tiny():
    return json.loads((HERE / "tiny.json").read_text())


def loaded_cell(cfg, mix, limits_of="v44k-bulk-longform", sample=64):
    """What ``run.load_cell`` gives, for the tiny configuration and a mix;
    the limits of a real cell."""
    limits = json.loads((BENCH / "cells" / f"{limits_of}.json").read_text())["limits"]
    return {"cell": {"chips": 1}, "cfg": cfg, "traffic": mix,
            "check": {"audio_sample": sample, "limits": limits},
            "end_to_end": [{"name": "audio_s_per_s", "unit": "x"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
