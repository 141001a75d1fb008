#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the sizes as run, its reference under
``references/``, the weight distributions), a traffic mix
(``traffic/<name>.json``, read by ``traffic.py``) and has its limits in
``cells/<workload>.json``.  A per-layer metric is ``metrics/<name>.py``,
or ``metrics/<name before the first dot>.py``, whose ``read(record)``
returns the value or None.  Adding a cell or a metric adds files.

A run: weights on the card from the seed; the program's ``TTSEngine``
built on them; every shape the mix can meet warmed; then the window:
``synthesize_batch`` calls back to back until the call in flight at
``--seconds`` ends.  With ``--trace 1`` the profiler records the device
over the whole window.  Then the program is freed and ``check.py`` holds
what it served against the reference; a run is correct only where no
call failed.  Standard error ends with each compared number beside its
limit; standard output ends with the JSON result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402

import check  # noqa: E402
import costs  # noqa: E402
import traffic as traffic_mod  # noqa: E402
import tracing  # noqa: E402
from weights import make_state  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vispeech_tpu")
MODES = ("batch_calls",)
CALIBRATION_ROWS, CALIBRATION_TOKENS = 64, 96


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> Dict:
    """The cell's entry, configuration, traffic, limits and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    reported = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload]) and m["moves"] in reported]
    return {"cell": cell,
            "cfg": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "check": json.loads((HERE / "cells" / f"{workload}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if m["name"] in reported],
            "per_layer": per_layer}


# ------------------------------------------------------------------ set-up

def calibrate_durations(ref, state, cfg, seed, device) -> float:
    """Shift the duration head's output bias so that the seeded model's
    mean predicted duration over a seeded batch is ``ms_per_token``; the
    shift that gives it (a few passes of the reference's text side)."""
    import torch

    w = cfg["weights"]
    target = w["ms_per_token"] * 1e-3 * cfg["data"]["sampling_rate"] / cfg["data"]["hop_length"]
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    ph = torch.randint(1, len(cfg["symbols"]), (CALIBRATION_ROWS, CALIBRATION_TOKENS),
                       generator=gen).to(device)
    sid = torch.randint(0, cfg["data"]["n_speakers"], (CALIBRATION_ROWS,), generator=gen).to(device)
    lengths = torch.full((CALIBRATION_ROWS,), CALIBRATION_TOKENS, device=device)
    bias = state["duration_predictor.proj.bias"]
    shift = 0.0
    for _ in range(3):
        wv = ref.text_side(ph, lengths, sid)[0]
        mean = float(torch.clamp(torch.ceil(wv), min=0.0).mean())
        step = math.log((target + 1.5) / (mean + 1.5))
        bias += step
        shift += step
    return shift


def reachable(traffic: Dict, cfg: Dict) -> Dict:
    """The buckets and phoneme paddings the mix can meet: its phoneme counts
    at the configuration's rate band of frames per phoneme."""
    ms = cfg["weights"]["ms_per_token"]
    per_token = ms * 1e-3 * cfg["data"]["sampling_rate"] / cfg["data"]["hop_length"]
    lo, hi = cfg["weights"]["rate_band"]
    counts = traffic_mod.length_range(traffic, ms)
    f_lo, f_hi = counts.start * per_token * lo, (counts.stop - 1) * per_token * hi
    buckets = sorted({check.pick_bucket(int(f)) for f in range(int(f_lo), int(f_hi) + 2, 16)}
                     | {check.pick_bucket(int(f_hi) + 1)})
    pads = sorted({check.phoneme_pad(n) for n in counts})
    return {"buckets": buckets, "pads": pads}


def warm(engine, traffic: Dict, cfg: Dict, seed: int) -> None:
    """Meet every shape the cell can meet once: each (bucket, tier) plan,
    each phoneme padding of each tier, and the mix's own calls."""
    import torch

    reach = reachable(traffic, cfg)
    tiers = traffic.get("tiers", check.DEFAULT_TIERS)
    model, dev = engine.model, engine.device
    with engine.policy.precision():
        i = 0
        for bucket in reversed(reach["buckets"]):
            for tier in tiers:
                pad = reach["pads"][i % len(reach["pads"])]
                i += 1
                ph = torch.ones(tier, pad, dtype=torch.long, device=dev)
                dur = torch.zeros(tier, pad, device=dev)
                dur[:, 0] = bucket
                audio = model.infer(ph, torch.full((tier,), pad, device=dev), bucket,
                                    sid=torch.zeros(tier, dtype=torch.long, device=dev),
                                    noise_scale=0.667, duration_control=dur,
                                    generator=torch.Generator(device=dev).manual_seed(0))[0]
                torch.round(torch.clamp(audio[..., 0], -1.0, 1.0) * 32767.0).to(
                    torch.int16).cpu()
    reqs = traffic_mod.batch_call(traffic, cfg, seed, -1)
    engine.synthesize_batch(phones_list=[r.phones for r in reqs],
                            speakers=[r.speaker for r in reqs],
                            noise_scale=traffic["noise_scale"], seed=0,
                            tiers=tuple(traffic["tiers"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ window

class Recorder:
    """What the window's requests got: every answer's durations, f0 and
    energy; the PCM of a seeded reservoir sample and of the longest."""

    def __init__(self, cfg: Dict, seed: int, sample: int):
        self.ids = {s: i for i, s in enumerate(cfg["symbols"])}
        self.sr = cfg["data"]["sampling_rate"]
        self.served: Dict[int, check.Served] = {}
        self.rng = random.Random(f"sample:{seed}")
        self.sample_size = max(sample - 1, 0)
        self.reservoir: List[int] = []
        self.seen = 0
        self.longest: Optional[int] = None
        self.audio_s = 0.0

    def add(self, rid: int, req, result: Dict) -> None:
        pcm = result["audio_int16"]
        self.audio_s += len(pcm) / self.sr
        keep = False
        if self.longest is None or len(pcm) > len(self.served[self.longest].pcm):
            if self.longest is not None and self.longest not in self.reservoir:
                self.served[self.longest].pcm = None
            self.longest, keep = rid, True
        self.seen += 1
        if len(self.reservoir) < self.sample_size:
            self.reservoir.append(rid)
            keep = True
        else:
            j = self.rng.randrange(self.seen)
            if j < self.sample_size:
                old = self.reservoir[j]
                if old != self.longest:
                    self.served[old].pcm = None
                self.reservoir[j] = rid
                keep = True
        self.served[rid] = check.Served(
            ids=np.array([self.ids[p] for p in req.phones]), speaker=req.speaker,
            duration=result["duration"], f0=result["f0"], energy=result["energy"],
            pcm=pcm if keep else None)

    def sample(self) -> List[int]:
        out = set(self.reservoir)
        if self.longest is not None:
            out.add(self.longest)
        return sorted(out)


class Tracer:
    """The profiler over the window (``--trace 1``): entered at the end of
    set-up, so that its start-up falls there, and recording markers from the
    window's start to its end."""

    def __init__(self, probe):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.probe = probe
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def start(self) -> None:
        self.probe.recording = True
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.probe.recording = False
        self.window_s = time.perf_counter() - self.t_start
        self.prof.__exit__(None, None, None)


def batch_window(engine, traffic, cfg, seed, seconds, recorder, on_start):
    """``synthesize_batch`` calls back to back until the one in flight at
    ``seconds`` ends."""
    calls: List[check.EngineCall] = []
    attempted = failed = 0
    rid = 0
    call_s: List[float] = []
    on_start()
    t_start = time.perf_counter()
    k = 0
    while True:
        reqs = traffic_mod.batch_call(traffic, cfg, seed, k)
        call_seed = (seed * 7919 + k) % (1 << 62)
        ids = list(range(rid, rid + len(reqs)))
        rid += len(reqs)
        attempted += len(reqs)
        t_call = time.perf_counter()
        try:
            out = engine.synthesize_batch(phones_list=[r.phones for r in reqs],
                                          speakers=[r.speaker for r in reqs],
                                          noise_scale=traffic["noise_scale"], seed=call_seed,
                                          tiers=tuple(traffic["tiers"]))
        except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
            print(f"call {k} failed: {e!r}", file=sys.stderr)
            failed += len(reqs)
            out = None
        call_s.append(time.perf_counter() - t_call)
        if out is not None:
            for i, req, res in zip(ids, reqs, out):
                recorder.add(i, req, res)
            calls.append(check.EngineCall(ids, call_seed, traffic["noise_scale"],
                                          t_call))
        k += 1
        if time.perf_counter() - t_start >= seconds:
            break
    window = time.perf_counter() - t_start
    return {"calls": calls, "attempted": attempted, "failed": failed, "window_s": window, "call_s": call_s, "t_start": t_start}


# ----------------------------------------------------------------- metrics

def trace_record(tracer, window, recorder, cfg) -> Optional[Dict]:
    """The device trace of the window, with the audio, model FLOPs, kernel
    bounds and real frames of the engine calls that started in it."""
    if tracer is None:
        return None
    t = tracing.device_trace(tracer.prof, tracer.probe.labels, tracer.window_s)
    m, hop = cfg["model"], cfg["data"]["hop_length"]
    audio_s = flops = frames = 0.0
    bounds = {"attn": 0.0, "wn": 0.0, "mrf": 0.0}
    for call in (c for c in window["calls"] if c.start >= window["t_start"]):
        served = [recorder.served[r] for r in call.requests]
        totals = [max(int(s.duration.sum()), 1) for s in served]
        for s, tot in zip(served, totals):
            audio_s += tot * hop / cfg["data"]["sampling_rate"]
            flops += costs.model_flops(len(s.ids), tot, m)
            frames += tot
        by_pad: Dict[int, List[int]] = {}
        for s in served:
            by_pad.setdefault(check.phoneme_pad(len(s.ids)), []).append(len(s.ids))
        for rows in by_pad.values():
            bounds["attn"] += costs.duration_pass_bound(rows, m)
        for _, _, idxs in check.plan_batches(totals):
            b = costs.plan_bounds([len(served[i].ids) for i in idxs], [totals[i] for i in idxs], m)
            for key in bounds:
                bounds[key] += b[key]
    t.update(audio_s=audio_s, model_flops=flops, bounds=bounds, frames_real=frames,
             frames_padded=tracer.probe.padded_frames)
    return t


def read_metrics(entries: List[Dict], record: Dict) -> Dict:
    out = {}
    for m in entries:
        name = m["name"]
        path = HERE / "metrics" / f"{name}.py"
        if not path.exists():
            path = HERE / "metrics" / f"{name.split('.')[0]}.py"
        value = load_module(path, f"metric_{path.stem.replace('.', '_')}").read(record)
        if value is not None:
            out[name] = {"value": value, "unit": m["unit"]}
    return out


# --------------------------------------------------------------------- run

def run_cell(loaded: Dict, seed: int, seconds: float, trace: bool, device_name: str,
             engine_hook=None) -> Dict:
    """One run of the cell on ``device_name``; → the result dict.
    ``engine_hook(engine)``, for tests, may alter the program under test."""
    import torch

    from vispeech_tpu_torch.config import config_from_dict
    from vispeech_tpu_torch.infer.pipeline import TTSEngine

    cell, cfg, tr = loaded["cell"], loaded["cfg"], loaded["traffic"]
    if tr["mode"] not in MODES:
        raise SystemExit(f"unknown traffic mode {tr['mode']!r}")
    dev = torch.device(device_name)
    ref_mod = load_module(HERE / "references" / f"{cfg['reference']}.py", "reference")
    spec = ref_mod.param_spec(cfg)
    marks = [("start", time.perf_counter() - T0)]
    state = make_state(spec, cfg["weights"], seed, dev)
    calibrate_durations(ref_mod.Reference(state, cfg), state, cfg, seed, dev)
    marks.append(("weights", time.perf_counter() - T0))
    engine = TTSEngine(config_from_dict(cfg), state, device=device_name, transfer_int16=True)
    if engine_hook is not None:
        engine_hook(engine)
    marks.append(("engine", time.perf_counter() - T0))
    warm(engine, tr, cfg, seed)
    marks.append(("warm", time.perf_counter() - T0))
    probe = tracing.Probe(engine.model) if trace else None
    tracer = Tracer(probe) if trace else None
    recorder = Recorder(cfg, seed, loaded["check"]["audio_sample"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    on_start = tracer.start if tracer else (lambda: None)
    window = batch_window(engine, tr, cfg, seed, seconds, recorder, on_start)
    setup_s = window["t_start"] - T0
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    record = {"mode": tr["mode"], "trace": trace_record(tracer, window, recorder, cfg)}
    if probe is not None:
        probe.close()
    del engine, tracer, probe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    ref = ref_mod.Reference(state, cfg)
    numbers = check.compare(ref, recorder.served, window["calls"], recorder.sample(),
                            cfg["model"]["inter_channels"], dev)
    limits = loaded["check"]["limits"]
    correct = (window["failed"] == 0 and bool(recorder.served)
               and all(numbers[k] <= limits[k] for k in check.NUMBERS))

    if trace:
        metrics = read_metrics(loaded["per_layer"], record)
    else:
        metrics = {}
        for m in loaded["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == "audio_s_per_s":
                value = recorder.audio_s / window["window_s"]
            else:
                raise SystemExit(f"no measurement for end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": peak}
    t = record["trace"]
    if t is not None and on_card:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["extra"] = {"setup_s": setup_s, "setup_marks": marks, "window_s": window["window_s"],
                       "audio_s": recorder.audio_s, "requests": len(recorder.served),
                       "calls": len(window["calls"]), "markers": t and t["markers"],
                       "forbidden": found, "call_s": window["call_s"]}
    result["checked"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    loaded = load_cell(ROOT, args.workload)
    # every build and kernel cache of the run under the checkout
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    import torch

    chips = loaded["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    result = run_cell(loaded, args.seed, args.seconds, bool(args.trace), "cuda")
    found = result["extra"]["forbidden"]
    if found:
        print(f"the run loaded modules of the JAX stack: {found}", file=sys.stderr)
        return 3
    extra = result.pop("extra")
    print(json.dumps({"extra": extra}), file=sys.stderr)
    for name, c in result["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
