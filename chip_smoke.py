#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Builds kernels A, B and C from ``vispeech_tpu_torch/csrc`` (one nvcc per
   source, all at once) and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (TF32 off) and times both: A at T = 1400 and 512,
   B at T = 1400 with L = 4 and a speaker, C at a 1400-frame bucket
   (358 400 samples) in bf16 and f32.
3. Builds the engine at the full width of ``configs/config.json`` with
   weights drawn from a seed, resets the launch counters and serves three
   ``synthesize`` requests (one with explicit durations in the 1400-frame
   bucket, one with pitch and energy arrays) and a ``synthesize_batch`` of
   8; then checks the counters against the launches the path must make,
   and the audio: finite, frames × hop long, and the whole path with the
   kernels in f32 against the plain f32 path on the CPU.  Two of
   the requests run again under torch.profiler: device time by kernel and
   the device's busy share of the wall time.
4. Prints the per-kernel JSON line, per-request latency, audio seconds per
   second, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, when there is no GPU, when the port's
package is not beside this file, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3, bytes/s
# f32 matrix-shaped work reaches f32 accuracy on the tensor cores as 3-pass
# TF32 (495 TFLOP/s dense / 3), faster than the 67 TFLOP/s CUDA cores;
# bf16 at its dense tensor-core rate
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
REPLACES = {
    "rel_attention": "vispeech_tpu/ops/pallas/flash_attention.py:103",
    "wn_stack": "vispeech_tpu/ops/pallas/wn_stack.py:105",
    "mrf_stage": "vispeech_tpu/ops/pallas/mrf_stage.py:197",
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def check_kernels(torch, dev):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from vispeech_tpu_torch.ops.kernels import mrf_stage, rel_attention, wn_stack

    gen = torch.Generator().manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = {}
    for T in (1400, 512):
        B, H, d = 1, 2, 96
        q, k, v = rn(B, H, T, d), rn(B, H, T, d), rn(B, H, T, d)
        rk, rv = rn(1, 9, d, scale=d ** -0.5), rn(1, 9, d, scale=d ** -0.5)
        n = T - 37
        mask = (torch.arange(T, device=dev) < n).float()[None]
        args = (q, k, v, rk, rv, mask)
        out = rel_attention.relative_self_attention(*args)
        ref = rel_attention.relative_self_attention_plain(*args)
        err = (out - ref)[:, :, :n].abs().max().item()
        ok = err <= 1e-4
        ms = time_ms(lambda: rel_attention.relative_self_attention(*args), 20)
        plain = time_ms(lambda: rel_attention.relative_self_attention_plain(*args), 20)
        b_ms, b_by = bound(nbytes(*args, out), 4.0 * B * H * T * T * d, "float32")
        print(f"kernel A rel_attention T={T}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e} (tol 1e-4 f32) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel A disagrees at T={T}: {err}")
        if T == 1400:
            rows["rel_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                         bound_ms=b_ms, bound_by=b_by)

    B, T, C, L, K = 1, 1400, 192, 4, 5
    x = rn(B, T, C)
    m = (torch.arange(T, device=dev) < T - 50).float()[None, :, None]
    args = (x, m, rn(B, L, 2 * C, scale=0.1), rn(L, K, C, 2 * C, scale=0.03),
            rn(L, C, 2 * C, scale=0.05), rn(L, 1, 2 * C, scale=0.1))
    out = wn_stack.wn_stack(*args, K)
    ref = wn_stack.wn_stack_plain(*args, K)
    err = (out - ref).abs().max().item()
    ms = time_ms(lambda: wn_stack.wn_stack(*args, K), 20)
    plain = time_ms(lambda: wn_stack.wn_stack_plain(*args, K), 20)
    flops = 2.0 * B * L * T * (K * C * 2 * C + C * 2 * C)
    b_ms, b_by = bound(nbytes(*args, out), flops, "float32")
    ok = err <= 1e-4
    print(f"kernel B wn_stack T={T} L={L}: {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e} (tol 1e-4 f32) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel B disagrees: {err}")
    rows["wn_stack"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by)

    ks, dils, C = (3, 7, 11), ((1, 3, 5),) * 3, 64
    T = 1400 * 512 // 2  # the C = 64 stage runs at hop / 2 samples per frame
    packed = [(rn(3, kk, C, C, scale=0.03), rn(3, 1, C, scale=0.1),
               rn(3, kk, C, C, scale=0.03), rn(3, 1, C, scale=0.1)) for kk in ks]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x = rn(1, T, C, dtype=dtype)
        out = mrf_stage.mrf_stack(x, packed, ks, dils)
        ref = mrf_stage.mrf_stack_plain(x, packed, ks, dils)
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        # f32: summation order; bf16: 2^-7 of the peak, one bf16 ulp in its binade
        tol = 1e-4 if dtype == torch.float32 else peak * 2.0 ** -7
        ms = time_ms(lambda: mrf_stage.mrf_stack(x, packed, ks, dils), 5)
        plain = time_ms(lambda: mrf_stage.mrf_stack_plain(x, packed, ks, dils), 5)
        w_bytes = sum(nbytes(w1, w2) * x.element_size() // 4 + nbytes(b1, b2)
                      for w1, b1, w2, b2 in packed)
        flops = 2.0 * T * C * C * 2 * sum(kk * len(d) for kk, d in zip(ks, dils))
        b_ms, b_by = bound(nbytes(x, out) + w_bytes, flops, name)
        ok = err <= tol
        print(f"kernel C mrf_stage T={T} {name}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel C disagrees in {name}: {err} > {tol}")
        if dtype == torch.bfloat16:
            rows["mrf_stage"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                     bound_ms=b_ms, bound_by=b_by)
    return rows


def pinyin_text(n_syllables: int, offset: int = 0) -> str:
    syl = ["ni2", "hao3", "shi4", "jie4", "wo3", "men5", "zou3", "ba5", "zai4", "jian4",
           "xie4", "tian1", "qi4", "zhen1", "bu2", "cuo4", "chi1", "fan4", "le5", "ma5"]
    return "[P]" + " ".join(syl[(offset + i) % len(syl)] for i in range(n_syllables)) + "[P]"


def serve(torch, dev, cfg, state_dict):
    """Phase 3: the engine at full width; returns the engine, the launch
    counts, the counts the path must make, and the requests."""
    import numpy as np

    from vispeech_tpu_torch.infer.batching import plan_batches
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops import kernels

    engine = TTSEngine(cfg, state_dict, device=dev.type, transfer_int16=True)
    hop, sr = cfg.data.hop_length, cfg.data.sampling_rate
    n_attn = cfg.model.n_layers          # TextEncoder / FramePriorNet layers
    n_pitch = 6                          # PitchPredictor layers
    long_text = pinyin_text(35)
    n_long = len(engine.phonemes(long_text))
    long_dur = [1400 // n_long + (i < 1400 % n_long) for i in range(n_long)]
    pe_text = pinyin_text(12, 5)
    n_pe = len(engine.phonemes(pe_text))
    r = torch.Generator().manual_seed(SEED)
    requests = [
        ("predicted", dict(text=pinyin_text(10), speaker=3, seed=1),
         n_attn + n_attn + n_pitch + n_attn),
        ("explicit durations, 1400-frame bucket",
         dict(text=long_text, speaker=17, duration_control=long_dur, seed=2),
         n_attn + n_pitch + n_attn),
        ("pitch and energy arrays",
         dict(text=pe_text, speaker=42, seed=3,
              pitch_control=(150 + 100 * torch.rand(n_pe, generator=r)).numpy(),
              energy_control=(50 + 20 * torch.rand(n_pe, generator=r)).numpy()),
         n_attn + n_attn + n_attn),
    ]
    batch_texts = [pinyin_text(6 + 5 * i, i) for i in range(8)]

    def run():
        results, latency = [], []
        for label, kw, _ in requests:
            t0 = time.perf_counter()
            results.append((label, engine.synthesize(**kw)))
            latency.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch = engine.synthesize_batch(texts=batch_texts, speakers=list(range(8)), seed=4)
        return results, latency, batch, time.perf_counter() - t0

    # a first pass meets every shape once (cuDNN and cuBLAS plans, the
    # kernels' build); the counted and timed pass comes after it
    run()
    kernels.reset_launches()
    results, latency, batch, batch_s = run()
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernels.KERNELS}

    expect = {"rel_attention": sum(n_a for _, _, n_a in requests),
              "wn_stack": 4 * len(requests), "mrf_stage": len(requests)}
    n_list = [len(o["phones"]) for o in batch]
    totals = [max(int(o["duration"].sum()), 1) for o in batch]
    n_plans = len(plan_batches(totals))
    n_pads = len({min(-(-max(n, 1) // 32) * 32, engine.max_phonemes) for n in n_list})
    expect["rel_attention"] += n_attn * n_pads + (n_attn + n_pitch + n_attn) * n_plans
    expect["wn_stack"] += 4 * n_plans
    expect["mrf_stage"] += n_plans

    for label, out in results + [(f"batch row {i}", o) for i, o in enumerate(batch)]:
        frames = int(out["duration"].sum())
        n = len(out["audio"])
        if n != frames * hop or len(out["audio_int16"]) != n:
            raise AssertionError(f"{label}: {n} samples for {frames} frames")
        if not np.isfinite(out["audio"]).all():
            raise AssertionError(f"{label}: non-finite audio")
    if results[1][1]["duration"].sum() != 1400:
        raise AssertionError("the explicit-duration request is not 1400 frames")

    req_audio = sum(len(o["audio"]) for _, o in results) / sr
    batch_audio = sum(len(o["audio"]) for o in batch) / sr
    for (label, out), dt in zip(results, latency):
        secs = len(out["audio"]) / sr
        print(f"request '{label}': {len(out['phones'])} phonemes, "
              f"{int(out['duration'].sum())} frames, {secs:.3f} s audio, "
              f"latency {dt * 1e3:.2f} ms, {secs / dt:.2f} audio-s/s")
    print(f"synthesize: {len(results)} requests, {req_audio:.3f} s audio in "
          f"{sum(latency):.4f} s: {req_audio / sum(latency):.2f} audio-s/s")
    print(f"synthesize_batch: 8 requests in {n_plans} plans, {batch_audio:.3f} s audio in "
          f"{batch_s:.4f} s: {batch_audio / batch_s:.2f} audio-s/s")
    return engine, counts, expect, requests


def profile_request(torch, engine, label, kw):
    """Phase 3c: one request under torch.profiler: device time by kernel and
    the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine.synthesize(**kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.synthesize(**kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not events:
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    if busy_ms <= 0:
        print(f"profile '{label}': wall {wall_ms:.2f} ms, device time not measured")
        return
    print(f"profile '{label}': wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_launch} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def reference_check(torch, dev, cfg, state_dict):
    """Phase 3b: the whole path on the card with the kernels in f32 against
    the plain versions on the CPU in f32, TF32 off, same weights.  Explicit
    durations and no prior noise: a ceil that flips on rounding would shift
    the audio, and the two devices' random streams differ."""
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops.policy import FLOAT32

    text = pinyin_text(14, 3)
    outs = {}
    for name, device in (("kernels", dev.type), ("plain", "cpu")):
        engine = TTSEngine(cfg, state_dict, device=device, policy=FLOAT32,
                           transfer_int16=False)
        n = len(engine.phonemes(text))
        outs[name] = engine.synthesize(text=text, speaker=5, noise_scale=0.0,
                                       duration_control=[4 + i % 3 for i in range(n)])
        del engine
    a, b = outs["kernels"], outs["plain"]
    err = float(abs(a["audio"] - b["audio"]).max())
    peak = float(abs(b["audio"]).max())
    ok = err <= 1e-3 * max(peak, 1e-3)
    print(f"reference: f32 path with kernels on the card vs plain f32 path on the CPU: "
          f"{len(b['audio'])} samples, max_abs_err {err:.3e}, "
          f"peak {peak:.3e} (tol 1e-3 of peak) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"f32 kernel path disagrees with the plain path: {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "vispeech_tpu_torch")):
        print("chip_smoke: vispeech_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
    from vispeech_tpu_torch.ops.kernels import _build
    from vispeech_tpu_torch.text import N_SYMBOLS

    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} kernels compiled in {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = check_kernels(torch, dev)

    cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
    model = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed=SEED)
    # random weights predict meaningless durations: bias the duration head
    # so a phoneme lasts about e^1.8 − 1 ≈ 5 frames
    with torch.no_grad():
        model.duration_predictor.proj.weight.mul_(0.1)
        model.duration_predictor.proj.bias.fill_(1.8)
    state_dict = model.state_dict()
    del model

    engine, counts, expect, requests = serve(torch, dev, cfg, state_dict)
    for label, kw, _ in requests[:2]:
        profile_request(torch, engine, label, kw)
    del engine
    torch.cuda.empty_cache()
    print(f"launches on the main path: {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    reference_check(torch, dev, cfg, state_dict)

    kernels = [dict(name=name, route="cuda",
                    source=f"vispeech_tpu_torch/csrc/{name}.cu",
                    replaces=REPLACES[name], launches=counts[name],
                    library_ms=None, **rows[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
