#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place one precision step below the configuration's (TF32 in the text side
and the flow, float8 in the vocoder), held to the float32 reference by the
same numbers and limits as a run.  It has to come out as not correct.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--calls 20]

It serves what a run of the cell serves: ``--calls`` calls of the cell's
mix, with the run's sample size.  One JSON line a seed.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import check  # noqa: E402
import traffic as traffic_mod  # noqa: E402
from run import ROOT, calibrate_durations, load_cell, load_module  # noqa: E402
from weights import make_state  # noqa: E402


def window_requests(loaded, seed, calls):
    """(requests id → (ids, speaker), engine calls) of one run's worth."""
    cfg, tr = loaded["cfg"], loaded["traffic"]
    ids = {s: i for i, s in enumerate(cfg["symbols"])}
    requests, engine_calls = {}, []
    for k in range(calls):
        reqs = traffic_mod.batch_call(tr, cfg, seed, k)
        base = len(requests)
        for j, r in enumerate(reqs):
            requests[base + j] = ([ids[p] for p in r.phones], r.speaker)
        engine_calls.append(check.EngineCall(list(range(base, base + len(reqs))),
                                             (seed * 7919 + k) % (1 << 62), tr["noise_scale"]))
    return requests, engine_calls


def control_numbers(loaded, seed, device, calls=20):
    """The control's four numbers on one seed's window."""
    cfg = loaded["cfg"]
    ref_mod = load_module(HERE / "references" / f"{cfg['reference']}.py", "reference")
    state = make_state(ref_mod.param_spec(cfg), cfg["weights"], seed, device)
    calibrate_durations(ref_mod.Reference(state, cfg), state, cfg, seed, device)
    requests, engine_calls = window_requests(loaded, seed, calls)
    n = loaded["check"]["audio_sample"]
    longest = max(requests, key=lambda r: len(requests[r][0]))
    rest = [r for r in requests if r != longest]
    random.Random(seed).shuffle(rest)
    sample = sorted([longest] + rest[:n - 1])
    inter = cfg["model"]["inter_channels"]
    served = check.emulate(ref_mod.Reference(state, cfg, lowp=True), requests, engine_calls,
                           sample, inter, device)
    return check.compare(ref_mod.Reference(state, cfg), served, engine_calls, sample, inter,
                         device)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    loaded = load_cell(ROOT, args.workload)
    limits = loaded["check"]["limits"]
    for seed in args.seeds:
        numbers = control_numbers(loaded, seed, torch.device("cuda"), args.calls)
        failed = [k for k in check.NUMBERS if numbers[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
