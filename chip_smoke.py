#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

1. Builds kernels A, B, C, D (serving) and E, F (training) from
   ``vispeech_tpu_torch/csrc`` (one nvcc per source, all at once) and
   prints the build time, each kernel's registers and any ptxas warning
   that it serialized a kernel's wgmma (C75xx).
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (TF32 off) and times both: A at T = 96, 512 and 1400
   (B = 1, H = 2, d = 96), B at T = 128 and 1400 with L = 4 and a speaker,
   and in its per-layer mode at T = 1400, L = 16 (the posterior encoder),
   its weights prepared once as serving calls it and, timed beside, at
   the call; each A and B line prints the grid (CTAs, cluster size, key
   splits or window).  C at the C = 64 stage of a 128- and a 1400-frame
   bucket (32 768 and 358 400 samples, batch 1) in bf16 and f32, its
   weights prepared once as the serving generator keeps them, with wall
   and device time, the grid, the bound and the plain version's time; D at
   the C = 32 stage (fold 4) of a 128- and a 1400-frame bucket (65 536 and
   716 800 samples, batch 1) and a batch of 2 at bucket 256, in bf16 with
   its weights prepared once, with wall and device time, the bound and the
   plain version's time; at 716 800 samples also in f32 and timed beside
   the cuDNN ResBlock1 stage it replaces (unfolded, bf16).
2b. E and F, forward and backward with every gradient, at the training
   shapes (B = 12, T = 1024): E with L = 16 and a speaker (enc_q) and
   L = 4 (a flow coupling), F with key padding at rates 0.1 and 0, each in
   f32 and with bf16 operands; E's bf16 backward at L = 16 and F's at
   T = 1024 also with their device time by sub-kernel (torch.profiler)
   beside their totals.  E's bf16 forward and F's bf16 forward and
   backward also on the operands the training step hands them (E: bf16 x
   and mask, the weights ``WN.packed`` builds from bf16-cast parameters and
   cond, f32, at L = 16 and T = 1024, 896 and 640; F: bf16 strided views at
   T = 1024, 640 and 128), each output held to the plain version on f32
   copies (out and every layer's xs for E; F's lse also within 1e-3
   absolute), with their device time by op.
3. Builds the engine at the full width of ``configs/config.json`` with
   weights drawn from a seed, resets the launch counters and serves three
   ``synthesize`` requests (one with explicit durations in the 1400-frame
   bucket, one with pitch and energy arrays) and a ``synthesize_batch`` of
   8; then checks the counters against the launches the path must make,
   and the audio: finite, frames × hop long, and the whole path with the
   kernels in f32 against the plain f32 path on the CPU.  The whole
   serving run once more under torch.profiler: each serving kernel's
   summed device time over it, and the (B, T) of each C launch.  C is
   held and timed once more at the largest batched plan of the run's
   ``synthesize_batch``.  Two of the requests run again under
   torch.profiler: device time by kernel and the device's busy share of
   the wall time.
3d. Voice conversion of the long request's audio (1400 frames) through
   ``TTSEngine.voice_conversion``: launch counts (B 16 per-layer launches
   for the posterior encoder + 4 + 4 couplings, C 1, D 1), finite audio
   of frames × hop samples, a profile, and the f32 conversion with the
   kernels on the card against the plain f32 conversion on the CPU with
   the posterior noise injected.
3e. HTTP serving: the same seeded weights saved as a port ``ckpt_1.pt``
   and a reference-style ``G_1.pth`` (``module.`` prefix, dead keys), an
   engine from each through ``TTSEngine.from_checkpoint`` (state dicts
   equal), the first behind the port's server (``infer/server.py``) on
   port 0 with the coalescer (20 ms window, max_batch 16).  From client
   threads, with the launch counters reset: the batch's 8 texts at once
   (valid 44.1 kHz WAV, frames × hop samples, at least one coalesced group
   of 2 or more), the short request with seed=5 amid 4 unseeded ones and
   alone (within 1 LSB of ``engine.synthesize(seed=5)``) and at sr=22050,
   the edited request's arrays by ``POST /tts``, ``/tts.json`` of the long
   text scaled into the 1400-frame bucket, ``POST /vc`` of the long
   request's 1400 frames, and a request over max_phonemes amid 3 good ones
   (it alone fails).  A, B, C and D must launch over HTTP, E and F not.
   Prints each request's wall time over HTTP beside the same request
   straight through the engine, and the 8 requests' audio-seconds per
   second.
4. Writes a synthetic corpus (44.1 kHz, 24 utterances of 512-1024 frames)
   to a temporary directory and trains at the full width of
   ``configs/config.json`` (batch 12, bf16 ``tail_f32``): a warm-up step
   through ``Trainer.train``, 5 timed steps with the launch counters
   (E 5 + 5, F 14 + 14 per step), one profiled step, finite losses, moved
   G and D parameters, a checkpoint and a fresh Trainer that resumes and
   takes one more step.
4b. One f32 train step at reduced depth and batch with the kernels on the
   card against the plain versions on the host CPU, within 1e-4 relative,
   and a control step with the bf16 stages on that must miss that limit.
5. Prints the per-kernel JSON line (A-D's launches over phases 3, 3d and
   3e), the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, when there is no GPU, when the port's
package is not beside this file, or when any phase fails.

    python3 chip_smoke.py --e-fwd

prints E's bf16 forward at B = 12, T = 1024, L = 16 on the training step's
operands: its time a call, its host dispatch and its device time by op
(the layer kernels, the wrapper's own copies and weight preparation), as
one JSON line last, for the checkout this file sits in.

    python3 chip_smoke.py --train

runs phase 4 alone and prints its step times, the profiled step's wall
and device busy time and the kernels' device time in it, as one JSON line
last, for the checkout this file sits in.

    python3 chip_smoke.py --e-bwd

prints E's bf16 backward at B = 12, T = 1024, L = 16: its time a call and
its device time by op (each sub-kernel over the 16 layers, the wrapper's own
ops), as one JSON line last, for the checkout this file sits in.

    python3 chip_smoke.py --f-fwd

prints F's bf16 forward at B = 12, H = 2, d = 96, rate 0.1 with padded
keys, at T = 1024, 640 and 128, on the training step's bf16 strided
operands: per T its time a call, its host dispatch and its device time by
op, as one JSON line last, for the checkout this file sits in.

    python3 chip_smoke.py --f-bwd

prints F's bf16 backward at B = 12, H = 2, d = 96, rate 0.1 with padded
keys, at T = 1024, 640 and 128: per T its time a call and its device time
by op (each kernel, the wrapper's own ops), as one JSON line last, for the
checkout this file sits in.

    python3 chip_smoke.py --http

runs phase 3e alone (the kernels built first) and prints its launch
counts as one JSON line last.

    python3 chip_smoke.py --kernel-times

prints only the times of kernels A and B at phase 2's shapes, of C in
bf16 at ``MRF_TIMED`` and of D in bf16 at ``FOLDED_TIMED`` (C's and D's
kernel alone too, from the profiler), as one JSON line, for the checkout this file sits in: a copy of this file in
another checkout of the port times that one, so two versions compare
within one run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
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
    "mrf_stage_folded": "vispeech_tpu/ops/pallas/mrf_stage.py:342",
    "wn_stack_train_fwd": "vispeech_tpu/ops/pallas/wn_stack_train.py:203",
    "wn_stack_train_bwd": "vispeech_tpu/ops/pallas/wn_stack_train.py:285",
    "rel_attention_train_fwd": "vispeech_tpu/ops/pallas/flash_attention_train.py:290",
    "rel_attention_train_bwd": "vispeech_tpu/ops/pallas/flash_attention_train.py:369",
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


def device_ms(fn, reps: int):
    """``fn``'s device time and host dispatch time per call, in ms: the
    stream sleeps ~25 ms first, so the host has queued all ``reps`` calls
    before the first one runs and the events see the device alone
    (``time_ms`` includes the host's dispatch when it is the slower)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def check_kernels(torch, dev):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from vispeech_tpu_torch.ops.kernels import rel_attention, wn_stack

    gen = torch.Generator().manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = {}
    for T in (32, 96, 512, 1400):
        B, H, d = 1, 2, 96
        q, k, v = rn(B, H, T, d), rn(B, H, T, d), rn(B, H, T, d)
        rk, rv = rn(1, 9, d, scale=d ** -0.5), rn(1, 9, d, scale=d ** -0.5)
        n = T - min(37, T // 4)
        mask = (torch.arange(T, device=dev) < n).float()[None]
        args = (q, k, v, rk, rv, mask)
        out = rel_attention.relative_self_attention(*args)
        ref = rel_attention.relative_self_attention_plain(*args)
        err = (out - ref)[:, :, :n].abs().max().item()
        ok = err <= 1e-4
        ms = time_ms(lambda: rel_attention.relative_self_attention(*args), 50)
        on_dev, host = device_ms(lambda: rel_attention.relative_self_attention(*args), 50)
        plain = time_ms(lambda: rel_attention.relative_self_attention_plain(*args), 20)
        b_ms, b_by = bound(nbytes(*args, out), 4.0 * B * H * T * T * d, "float32")
        print(f"kernel A rel_attention B={B} H={H} T={T}: {ms:.4f} ms ({on_dev:.4f} ms of "
              f"device time with calls queued ahead, {host:.4f} ms host dispatch), "
              f"plain {plain:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), grid {rel_attention.launch_grid(B, H, T)}, "
              f"max_abs_err {err:.3e} (tol 1e-4 f32) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel A disagrees at T={T}: {err}")
        if T == 1400:
            rows["rel_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                         bound_ms=b_ms, bound_by=b_by)

    C, K = 192, 5
    for T, L in ((128, 4), (1400, 4), (1400, 16)):
        # L = 16 is the posterior encoder, B's per-layer mode: one launch a layer
        B = 1
        x = rn(B, T, C)
        m = (torch.arange(T, device=dev) < T - 50).float()[None, :, None]
        w_rs = rn(L, C, 2 * C, scale=0.05)
        w_rs[-1, :, C:] = 0.0
        args = (x, m, rn(B, L, 2 * C, scale=0.1), rn(L, K, C, 2 * C, scale=0.03), w_rs,
                rn(L, 1, 2 * C, scale=0.1))
        # as serving calls it: the weights prepared once (WN.kernel_operands)
        prep = wn_stack.prepare_weights(args[3], args[4])
        served = args[:3] + (None, None, args[5], K, prep)
        before = wn_stack.launches
        out = wn_stack.wn_stack(*served)
        n_launch = wn_stack.launches - before
        if not torch.equal(out, wn_stack.wn_stack(*args, K)):
            raise AssertionError("kernel B differs with weights prepared ahead and at the call")
        ref = wn_stack.wn_stack_plain(*args, K)
        err = (out - ref).abs().max().item()
        peak = ref.abs().max().item()
        # one launch: 5e-5 abs (as the card tests); per-layer mode: 1e-4 of
        # the peak over 16 layers
        tol = 1e-4 * max(peak, 1.0) if L == 16 else 5e-5
        ms = time_ms(lambda: wn_stack.wn_stack(*served), 50)
        plain = time_ms(lambda: wn_stack.wn_stack_plain(*args, K), 20)
        at_call = time_ms(lambda: wn_stack.wn_stack(*args, K), 20)
        ms2 = time_ms(lambda: wn_stack.wn_stack(*served), 50)
        on_dev, host = device_ms(lambda: wn_stack.wn_stack(*served), 50)
        flops = 2.0 * B * L * T * (K * C * 2 * C + C * 2 * C)
        b_ms, b_by = bound(nbytes(*args, out), flops, "float32")
        ok = err <= tol and n_launch == wn_stack.expected_launches(L, K)
        print(f"kernel B wn_stack B={B} T={T} L={L}: {n_launch} launches, {ms:.4f} / "
              f"{ms2:.4f} ms ({on_dev:.4f} ms of device time with calls queued ahead, "
              f"{host:.4f} ms host dispatch; "
              f"{at_call:.4f} ms preparing the weights at the call), "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} GFLOP), "
              f"grid {wn_stack.launch_grid(B, T, L, K)}, max_abs_err {err:.3e} "
              f"(peak {peak:.3e}, tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        ms = min(ms, ms2)
        if not ok:
            raise AssertionError(f"kernel B disagrees or launched {n_launch} at T={T} L={L}: "
                                 f"{err}")
        if (T, L) == (1400, 4):
            rows["wn_stack"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by)

    # kernel C at the C = 64 stage of a 128- and a 1400-frame bucket (256
    # samples a frame); a batched shape of the serving run follows phase 3
    rows["mrf_stage"] = check_mrf(torch, dev, MRF_TIMED[:2])
    rows["mrf_stage_folded"] = check_folded(torch, dev, rn, nbytes)
    return rows


MRF_SAMPLES = 256   # samples a frame at the C = 64 stage: hop 512 over the last ×2 upsample
MRF_KS, MRF_DILS = (3, 7, 11), ((1, 3, 5),) * 3
# kernel C's timed (B, T): buckets 128 and 1400 at batch 1, and a batch of 2
# at bucket 256 (the serving run's own batched plan is held and timed after
# phase 3, where it is known)
MRF_TIMED = ((1, 128 * MRF_SAMPLES), (1, 1400 * MRF_SAMPLES), (2, 256 * MRF_SAMPLES))


def mrf_weights(torch, dev, gen, C=64, scale=0.03):
    """Kernel C's weights (ResBlock1.packed() per branch), or D's at C < 64,
    drawn from gen."""
    def rn(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return [(rn(3, k, C, C, scale=scale), rn(3, 1, C, scale=0.1), rn(3, k, C, C, scale=scale),
             rn(3, 1, C, scale=0.1)) for k in MRF_KS]


def kernel_ms(torch, fn, func: str, reps: int) -> float:
    """Mean device time of the kernels named ``func`` over ``reps`` calls of
    ``fn``, from torch.profiler's CUDA activity: the kernel alone, whatever
    else the call launches; 0 when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if func in e.key]
    return sum(e.self_device_time_total for e in hits) / 1e3 / reps


def check_mrf(torch, dev, shapes):
    """Kernel C at each (B, T) of ``shapes`` against its plain version in
    f32 and bf16, its weights prepared once as the serving generator keeps
    them (equal to preparing them at the call), with wall time, device time
    (calls queued ahead), host dispatch, the plain version's time, the bound
    and the grid.  → the JSON row of the last shape's bf16 run."""
    from vispeech_tpu_torch.ops.kernels import mrf_stage

    gen = torch.Generator().manual_seed(SEED + 2)
    packed = mrf_weights(torch, dev, gen)
    ks, dils, C = MRF_KS, MRF_DILS, 64
    flops_per_sample = 2.0 * C * C * 2 * sum(k * len(d) for k, d in zip(ks, dils))
    row = None
    for B, T in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x = (torch.randn(B, T, C, generator=gen)).to(dev, dtype)
            prep = mrf_stage.prepare_weights(packed, ks, dils, dtype)
            out = mrf_stage.mrf_stack(x, None, ks, dils, prep)
            if not torch.equal(out, mrf_stage.mrf_stack(x, packed, ks, dils)):
                raise AssertionError("kernel C differs with weights prepared ahead and at the "
                                     "call")
            ref = mrf_stage.mrf_stack_plain(x, packed, ks, dils)
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            # f32: summation order; bf16: 2^-7 of the peak, one bf16 ulp in its binade
            tol = 1e-4 if dtype == torch.float32 else peak * 2.0 ** -7
            ok = err <= tol
            call = lambda: mrf_stage.mrf_stack(x, None, ks, dils, prep)  # noqa: E731
            reps = 3 if dtype == torch.float32 else max(5, min(50, 2 ** 23 // (B * T)))
            ms = time_ms(call, reps)
            on_dev, host = device_ms(call, reps)
            plain = time_ms(lambda: mrf_stage.mrf_stack_plain(x, packed, ks, dils),
                            max(2, reps // 5))
            nb = (x.numel() + out.numel()) * x.element_size() + (
                prep.w.numel() * prep.w.element_size() + prep.b.numel() * 4)
            b_ms, b_by = bound(nb, flops_per_sample * B * T, name)
            print(f"kernel C mrf_stage B={B} T={T} {name}: {ms:.4f} ms ({on_dev:.4f} ms of "
                  f"device time with calls queued ahead, {host:.4f} ms host dispatch), plain "
                  f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{flops_per_sample * B * T / 1e9:.1f} GFLOP), grid "
                  f"{mrf_stage.launch_grid(B, T)}, max_abs_err {err:.3e} (peak {peak:.3e}, "
                  f"tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel C disagrees at B={B} T={T} in {name}: "
                                     f"{err} > {tol}")
            if dtype == torch.bfloat16:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by)
    return row


def kernel_times(torch, dev) -> dict:
    """Kernels A and B at phase 2's shapes (B = 1), C at ``MRF_TIMED`` and D
    at ``FOLDED_TIMED`` (bf16), each call's time (events around back-to-back
    calls) and device time (calls queued ahead), and for C and D the
    kernel's own device time (profiler),
    through the interface every version of their wrappers has: the same
    script times two checkouts of the port for an A/B in one run
    (--kernel-times)."""
    from vispeech_tpu_torch.ops.kernels import rel_attention, wn_stack

    gen = torch.Generator().manual_seed(SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    times = {}
    for T in (32, 96, 512, 1400):
        H, d = 2, 96
        mask = (torch.arange(T, device=dev) < T - min(37, T // 4)).float()[None]
        args = (rn(1, H, T, d), rn(1, H, T, d), rn(1, H, T, d), rn(1, 9, d, scale=d ** -0.5),
                rn(1, 9, d, scale=d ** -0.5), mask)
        call = lambda: rel_attention.relative_self_attention(*args)  # noqa: E731
        times[f"A T={T}"] = (time_ms(call, 50), device_ms(call, 50)[0])
    C, K = 192, 5
    prepare = getattr(wn_stack, "prepare_weights", None)   # absent before the redesign
    for T, L in ((128, 4), (1400, 4), (1400, 16)):
        mask = (torch.arange(T, device=dev) < T - 50).float()[None, :, None]
        args = (rn(1, T, C), mask, rn(1, L, 2 * C, scale=0.1), rn(L, K, C, 2 * C, scale=0.03),
                rn(L, C, 2 * C, scale=0.05), rn(L, 1, 2 * C, scale=0.1))
        if prepare is None:
            call = lambda: wn_stack.wn_stack(*args, K)  # noqa: E731
        else:
            prep = prepare(args[3], args[4])
            call = lambda: wn_stack.wn_stack(*args[:3], None, None, args[5], K, prep)  # noqa: E731
        times[f"B T={T} L={L}"] = (time_ms(call, 20), device_ms(call, 20)[0])
    # kernel C in bf16 at phase 2's shapes and a batched one of the serving
    # run; the kernel's own device time from the profiler besides, since a
    # version without prepared weights packs them on the card at each call
    from vispeech_tpu_torch.ops.kernels import mrf_stage

    packed = mrf_weights(torch, dev, gen)
    prepare = getattr(mrf_stage, "prepare_weights", None)
    for B, T in MRF_TIMED:
        x = rn(B, T, 64).bfloat16()
        if prepare is None:
            call = lambda: mrf_stage.mrf_stack(x, packed, MRF_KS, MRF_DILS)  # noqa: E731
        else:
            prep = prepare(packed, MRF_KS, MRF_DILS, torch.bfloat16)
            call = lambda: mrf_stage.mrf_stack(x, None, MRF_KS, MRF_DILS, prep)  # noqa: E731
        reps = max(5, min(50, 2 ** 23 // (B * T)))
        times[f"C B={B} T={T}"] = (time_ms(call, reps), device_ms(call, reps)[0],
                                   kernel_ms(torch, call, "mrf_stage_kernel", reps))
    # kernel D in bf16 at FOLDED_TIMED, its weights prepared once (every
    # version of its wrapper takes them so)
    from vispeech_tpu_torch.ops.kernels import mrf_stage_folded

    packed = mrf_weights(torch, dev, gen, FOLDED_C, scale=0.05)
    prep = mrf_stage_folded.prepare_weights(packed, MRF_KS, MRF_DILS, FOLDED_FOLD, FOLDED_C,
                                            torch.bfloat16)
    for B, T in FOLDED_TIMED:
        x = rn(B, T, FOLDED_C).bfloat16()
        call = lambda: mrf_stage_folded.mrf_stack_folded(  # noqa: E731
            x, None, MRF_KS, MRF_DILS, FOLDED_FOLD, prep)
        reps = max(5, min(50, 2 ** 24 // (B * T)))
        times[f"D B={B} T={T}"] = (time_ms(call, reps), device_ms(call, reps)[0],
                                   kernel_ms(torch, call, "mrf_folded_kernel", reps))
    return times


FOLDED_C, FOLDED_FOLD = 32, 4   # the C = 32 stage at fold 4: hop 512 over the last ×2 ×4
# kernel D's timed (B, T): buckets 128 and 1400 at batch 1, and a batch of 2
# at bucket 256 (512 samples a frame)
FOLDED_TIMED = ((1, 128 * 512), (1, 1400 * 512), (2, 256 * 512))


def check_folded(torch, dev, rn, nbytes):
    """Kernel D at the C = 32 stage (fold 4) of ``FOLDED_TIMED`` against its
    plain version in bf16, its weights prepared once as the serving
    generator keeps them (equal to folding them at the call), with wall and
    device time, the plain version's time and the bound; at the 1400-frame
    bucket (716 800 samples) also in f32, and timed beside the stage D
    replaced: three cuDNN ResBlock1 branches, unfolded, bf16.  → the JSON
    row of the 1400-frame bucket's bf16 run."""
    from vispeech_tpu_torch.ops.folded_mrf import folded_units
    from vispeech_tpu_torch.ops.kernels import mrf_stage_folded as D
    from vispeech_tpu_torch.ops.resblock import ResBlock1

    ks, dils, C, fold = MRF_KS, MRF_DILS, FOLDED_C, FOLDED_FOLD
    packed = mrf_weights(torch, dev, torch.Generator().manual_seed(SEED + 3), C, scale=0.05)
    blocks = []
    for (w1, b1, w2, b2), kk, d in zip(packed, ks, dils):
        block = ResBlock1(C, kk, d).to(dev)
        for u in range(len(d)):
            for conv, w, b in ((block.convs1[u], w1, b1), (block.convs2[u], w2, b2)):
                conv.folded = w[u].permute(2, 1, 0).contiguous()
                conv.bias.data.copy_(b[u, 0])
        blocks.append(block)

    def cudnn_stage(x_cf):
        with torch.no_grad():
            return sum(block.forward_cf(x_cf) for block in blocks) / len(blocks)

    # the function's own work (unfolded) per sample, and the folded convs D computes
    flops_per_sample = 2.0 * C * C * 2 * sum(kk * len(d) for kk, d in zip(ks, dils))
    taps = sum(wf.shape[0] for units in folded_units(packed, dils, fold)
               for unit in units for wf, _, _ in unit)
    row = None
    for B, T in FOLDED_TIMED:
        long = T == 1400 * 512
        for dtype in (torch.float32, torch.bfloat16) if long else (torch.bfloat16,):
            name = str(dtype).split(".")[1]
            x = rn(B, T, C, dtype=dtype)
            prepared = D.prepare_weights(packed, ks, dils, fold, C, dtype)
            call = lambda: D.mrf_stack_folded(x, None, ks, dils, fold, prepared)  # noqa: E731
            out = call()
            if not torch.equal(out, D.mrf_stack_folded(x, packed, ks, dils, fold)):
                raise AssertionError("kernel D differs with weights prepared ahead and at the "
                                     "call")
            ref = D.mrf_stack_folded_plain(x, packed, ks, dils, fold)
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            # f32: summation order over up to 15 · 128 terms; bf16: one ulp at the peak
            tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * peak
            ok = err <= tol
            w_bytes = sum(nbytes(w1, w2) * x.element_size() // 4 + nbytes(b1, b2)
                          for w1, b1, w2, b2 in packed)
            flops = flops_per_sample * B * T
            folded_flops = 2.0 * B * (T // fold) * (fold * C) ** 2 * taps
            b_ms, b_by = bound(nbytes(x, out) + w_bytes, flops, name)
            fb_ms, _ = bound(nbytes(x, out) + w_bytes, folded_flops, name)
            print(f"kernel D mrf_stage_folded B={B} T={T} C={C} fold={fold} {name}: max_abs_err "
                  f"{err:.3e} (peak {peak:.3e}, tol {tol:.3e}) {'ok' if ok else 'FAIL'}; bound "
                  f"{b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP of the stage), "
                  f"{fb_ms:.4f} ms for the {folded_flops / 1e9:.1f} GFLOP of {taps} folded taps")
            if not ok:
                raise AssertionError(f"kernel D disagrees at B={B} T={T} in {name}: "
                                     f"{err} > {tol}")
            if dtype != torch.bfloat16:
                ms = time_ms(call, 3)
                plain = time_ms(lambda: D.mrf_stack_folded_plain(x, packed, ks, dils, fold), 2)
                print(f"  f32 times: D {ms:.4f} ms, plain folded {plain:.4f} ms")
                continue
            reps = max(5, min(50, 2 ** 24 // (B * T)))
            # in turns: D, plain, D; D as serving calls it (weights prepared
            # once) and folding them at the call
            ms = time_ms(call, reps)
            plain = time_ms(lambda: D.mrf_stack_folded_plain(x, packed, ks, dils, fold),
                            max(2, reps // 5))
            ms2 = time_ms(call, reps)
            on_dev, host = device_ms(call, reps)
            at_call = time_ms(lambda: D.mrf_stack_folded(x, packed, ks, dils, fold), 5)
            print(f"  bf16 times: D {ms:.4f} / {ms2:.4f} ms ({on_dev:.4f} ms of device time "
                  f"with calls queued ahead, {host:.4f} ms host dispatch; {at_call:.4f} ms "
                  f"folding the weights at the call), plain folded {plain:.4f} ms")
            if not long:
                continue
            x_cf = x.transpose(1, 2).contiguous()
            diff = (cudnn_stage(x_cf).transpose(1, 2).float() - ref.float()).abs().max().item()
            unfolded = time_ms(lambda: cudnn_stage(x_cf), 5)
            print(f"  cuDNN ResBlock1 stage (unfolded, bf16) {unfolded:.4f} ms; it differs from "
                  f"D's plain version by {diff:.3e} (bf16 rounding at other places)")
            row = dict(max_abs_err=err, ms=min(ms, ms2), plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by)
    return row


def _held(name, outs, refs, bf16):
    """Max error of each output against its plain version, within f32: 1e-4
    of the tensor's peak (summation order); bf16 operands: 2^-7 of the peak,
    one bf16 ulp in the peak's binade.  Raises on a miss."""
    worst = 0.0
    for label, a, b in zip(name[1], outs, refs):
        err = (a.float() - b.float()).abs().max().item()
        peak = b.float().abs().max().item()
        tol = (2.0 ** -7 if bf16 else 1e-4) * max(peak, 1e-6)
        ok = err <= tol
        print(f"    {name[0]} {label}: max_abs_err {err:.3e}, peak {peak:.3e}, "
              f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name[0]} {label} disagrees: {err} > {tol}")
        worst = max(worst, err)
    return worst


def _op_name(key: str) -> str:
    """A device op's profiler key without its return type, namespace and
    arguments: ``void (anonymous namespace)::bwd_act<true>(float const*, ...)``
    → ``bwd_act<true>``."""
    head = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return head.split("(", 1)[0][:60]


E_BWD_SHAPE = (12, 1024, 16, 5)   # B, T, L, k: enc_q, the main path's largest E call
E_FWD_T = (1024, 896, 640)        # phase 2b's T for E's forward: 1024 and two frame buckets


def e_step_operands(torch, dev, T: int) -> tuple:
    """Kernel E's forward's operands at ``E_BWD_SHAPE``'s B, L, k and T, as
    the training step hands them over in ``enc_q`` (bf16 ``tail_f32``): a WN
    of C = 192 with a 256-channel speaker, its parameters drawn from a seed
    and cast to bf16; bf16 x and length mask (lengths T − 37·(b % 3)); and
    ``WN.packed``'s cond, w_in (a permuted view), w_rs and b_rs, all f32 (the
    weight norm computes in f32 from the bf16 parameters).
    → (x, mask, cond, w_in, w_rs, b_rs)."""
    from vispeech_tpu_torch.models.synthesizer import random_init_
    from vispeech_tpu_torch.ops.wavenet import WN

    B, _, L, K = E_BWD_SHAPE
    wn = random_init_(WN(192, K, 1, L, gin_channels=256), SEED + 7).to(dev, torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 8)
    x = torch.randn(B, T, 192, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(B, 1, 256, generator=gen).to(dev, torch.bfloat16)
    lengths = torch.tensor([T - 37 * (i % 3) for i in range(B)], device=dev)
    mask = (torch.arange(T, device=dev)[None, :, None] < lengths[:, None, None]).bfloat16()
    with torch.no_grad():
        return (x, mask, *wn.packed(B, g))


def e_fwd_breakdown(torch, dev, reps: int = 5, T: int = E_BWD_SHAPE[1]) -> dict:
    """Kernel E's bf16 forward on ``e_step_operands`` at T: its time per
    call, host dispatch and device time per call by op, through
    ``_launch_fwd``, which every version of the wrapper has: a copy of this
    file in another checkout measures that one (--e-fwd).  "grads" holds
    (out, xs)."""
    from vispeech_tpu_torch.ops.kernels import wn_stack_train as E_

    ops = e_step_operands(torch, dev, T)
    return _by_op(torch, lambda: E_._launch_fwd(*ops, E_BWD_SHAPE[3], True), reps)


def check_e_fwd(torch, dev, T: int) -> dict:
    """Phase 2b: kernel E's bf16 forward on the training step's operands at
    T (``e_step_operands``), out and every layer's xs held to the plain
    version on f32 copies of the same operands (``_held``'s 2^-7 of each
    peak), and its time by op.  → {"max_abs_err", "ms", "device_ms", ...}."""
    from vispeech_tpu_torch.ops.kernels import wn_stack_train as E_

    _, _, L, K = E_BWD_SHAPE
    ops = e_step_operands(torch, dev, T)
    r = _by_op(torch, lambda: E_._launch_fwd(*ops, K, True), 5)
    out, xs = r.pop("grads")
    ref, xs_ref = E_.wn_stack_train_plain_fwd(*(t.float() for t in ops), K, True)
    print(f"kernel E bf16 forward on the training step's operands, T={T}, L={L}:")
    labels = ("out",) + tuple(f"xs[:, {l}]" for l in range(L))
    r["max_abs_err"] = _held(("fwd", labels), (out, *xs.unbind(1)), (ref, *xs_ref.unbind(1)),
                             True)
    print_e_fwd(T, r)
    return r


def print_e_fwd(T: int, r: dict) -> None:
    B, _, L, K = E_BWD_SHAPE
    print(f"  wn_stack_train_fwd B={B} T={T} L={L} k={K} bf16: {r['ms']:.4f} ms a call "
          f"({r['host_ms']:.4f} ms of host dispatch), {r['device_ms']:.4f} ms of device time "
          f"by the profiler:")
    for name, (ms, n) in r["ops"].items():
        print(f"    {ms:9.4f} ms  x{n:<4d} {name}")


def e_bwd_breakdown(torch, dev, reps: int = 5) -> dict:
    """Kernel E's bf16 backward at ``E_BWD_SHAPE``: its time per call
    (events around back-to-back calls) and, from torch.profiler, the device
    time per call of each op it launches (each sub-kernel summed over the
    layers; the wrapper's own copies, casts and sums), through
    ``_launch_fwd`` and ``_launch_bwd``, which every version of the wrapper
    has: a copy of this file in another checkout measures that one
    (--e-bwd).  → {"ms", "device_ms", "ops": {name: [ms, launches]}, "grads"}."""
    from vispeech_tpu_torch.ops.kernels import wn_stack_train as E_

    B, T, L, K = E_BWD_SHAPE
    C = 192
    gen = torch.Generator().manual_seed(SEED + 5)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    m = (torch.arange(T, device=dev)[None, :, None]
         < torch.tensor([T - 37 * (i % 3) for i in range(B)], device=dev)[:, None, None]).float()
    w_rs = rn(L, C, 2 * C, scale=0.05)
    w_rs[-1, :, C:] = 0.0
    args = (rn(B, T, C), m, rn(B, L, 2 * C, scale=0.3), rn(L, K, C, 2 * C, scale=0.03), w_rs,
            rn(L, 1, 2 * C, scale=0.1))
    dout = rn(B, T, C)
    _, xs = E_._launch_fwd(*args, K, True)
    return _by_op(torch, lambda: E_._launch_bwd(dout, xs, *args[1:5], K, True), reps)


def _by_op(torch, call, reps: int) -> dict:
    """``call``'s time per call (events around back-to-back calls), its host
    dispatch time per call (``device_ms``) and, from torch.profiler, the
    device time per call of each op it launches.
    → {"ms", "host_ms", "device_ms", "ops": {name: [ms, launches]}, "grads": call()}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    ms = time_ms(call, reps)
    host_ms = device_ms(call, reps)[1]
    call()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = _op_name(e.key)
            t, n = ops.get(name, (0.0, 0))
            ops[name] = (t + e.self_device_time_total / 1e3 / reps, n + e.count // reps)
    return {"ms": ms, "host_ms": host_ms, "device_ms": sum(t for t, _ in ops.values()),
            "ops": {k: list(v) for k, v in sorted(ops.items(), key=lambda kv: -kv[1][0])},
            "grads": call()}


def print_e_bwd(r: dict) -> None:
    B, T, L, K = E_BWD_SHAPE
    print(f"  wn_stack_train_bwd B={B} T={T} L={L} bf16: {r['ms']:.4f} ms a call, "
          f"{r['device_ms']:.4f} ms of device time by the profiler:")
    for name, (ms, n) in r["ops"].items():
        print(f"    {ms:9.4f} ms  x{n:<4d} {name}")


F_BWD_SHAPE = (12, 2, 96)         # B, H, d: the text side's attention layers
F_BWD_T = (1024, 640, 128)         # phase 2b's T, a frame bucket, a phoneme length
F_RATE = 0.1


def f_bwd_inputs(torch, dev, T: int) -> tuple:
    """Kernel F's backward's inputs at ``F_BWD_SHAPE`` and T, as the
    attention layer of the training step hands them over: q, k, v and dO
    bf16 [B, T, H, d] projections seen as [B, H, T, d], bf16 rel tables,
    keys padded by 0, 37 and 74 in turn; out and lse from the kernel's
    forward at rate 0.1.  → (dout, q, k, v, rel_k, rel_v, key_mask, out, lse)."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_

    B, H, d = F_BWD_SHAPE
    gen = torch.Generator().manual_seed(SEED + 6)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    lengths = torch.tensor([T - 37 * (i % 3) for i in range(B)], device=dev)
    key_mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    q, k, v, dout = (rn(B, T, H, d).bfloat16().transpose(1, 2) for _ in range(4))
    rel_k, rel_v = (rn(1, 9, d, scale=d ** -0.5).bfloat16() for _ in range(2))
    out, lse = F_._launch_fwd(q, k, v, rel_k, rel_v, key_mask, 99, F_RATE, 4, True)
    return dout, q, k, v, rel_k, rel_v, key_mask, out, lse


def f_fwd_breakdown(torch, dev, T: int, reps: int = 5) -> dict:
    """Kernel F's bf16 forward on the training step's operands at T
    (``f_bwd_inputs``' bf16 q, k, v views, bf16 rel tables, key mask): its
    time per call, host dispatch and device time per call by op, through
    ``_launch_fwd``, which every version of the wrapper has: a copy of this
    file in another checkout measures that one (--f-fwd).  "grads" holds
    (out, lse)."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_

    ops = f_bwd_inputs(torch, dev, T)[1:7]
    return _by_op(torch, lambda: F_._launch_fwd(*ops, 99, F_RATE, 4, True), reps)


def check_f_fwd(torch, dev, T: int) -> dict:
    """Phase 2b: kernel F's bf16 forward on the training step's operands at
    T (``f_fwd_breakdown``), out and lse held to the plain version on f32
    copies of the same operands (``_held``'s 2^-7 of each peak), lse also
    within 1e-3 absolute, since the backward rebuilds p = exp(s − lse) from
    it, and its device time by op.  → the breakdown with ``max_abs_err``."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_

    r = f_fwd_breakdown(torch, dev, T)
    out, lse = r.pop("grads")
    f = [t.float() for t in f_bwd_inputs(torch, dev, T)[1:7]]
    ref, lse_ref = F_.relative_self_attention_train_plain_fwd(*f, 99, F_RATE, 4, True)
    print(f"kernel F bf16 forward on the training step's operands, T={T}:")
    r["max_abs_err"] = _held(("fwd", ("out", "lse")), (out, lse), (ref, lse_ref), True)
    err = (lse - lse_ref).abs().max().item()
    print(f"    fwd lse: max_abs_err {err:.3e}, limit 1e-3 absolute "
          f"{'ok' if err <= 1e-3 else 'FAIL'}")
    if not err <= 1e-3:
        raise AssertionError(f"fwd lse disagrees: {err} > 1e-3")
    print_f("fwd", T, r)
    return r


def f_bwd_breakdown(torch, dev, T: int, reps: int = 5) -> dict:
    """Kernel F's bf16 backward on ``f_bwd_inputs(T)``: its time per call and
    the device time per call of each op it launches (the backward's kernels
    and the wrapper's own casts, sums and allocations), through
    ``_launch_fwd`` and ``_launch_bwd``, which every version of the wrapper
    has: a copy of this file in another checkout measures that one
    (--f-bwd)."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_

    x = f_bwd_inputs(torch, dev, T)
    return _by_op(torch, lambda: F_._launch_bwd(*x, 99, F_RATE, 4, True), reps)


def check_f_bwd(torch, dev, T: int) -> dict:
    """Phase 2b: kernel F's bf16 backward at the training step's operands and
    T (``f_bwd_breakdown``), its gradients held to the plain version's on f32
    copies of the same inputs (``_held``'s 2^-7 of each peak), and its device
    time by op.  → the breakdown with ``max_abs_err``."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_

    r = f_bwd_breakdown(torch, dev, T)
    grads = r.pop("grads")
    dout, q, k, v, rel_k, rel_v, key_mask = (t.float() for t in f_bwd_inputs(torch, dev, T)[:7])
    _, lse = F_.relative_self_attention_train_plain_fwd(q, k, v, rel_k, rel_v, key_mask, 99,
                                                        F_RATE, 4, True)
    refs = F_.relative_self_attention_train_plain_bwd(dout, q, k, v, rel_k, rel_v, key_mask, lse,
                                                      99, F_RATE, 4, True)
    print(f"kernel F bf16 backward on the training step's operands, T={T}:")
    r["max_abs_err"] = _held(("bwd", ("dq", "dk", "dv", "drel_k", "drel_v")), grads, refs, True)
    print_f("bwd", T, r)
    return r


def print_f(direction: str, T: int, r: dict) -> None:
    """Kernel F's bf16 forward or backward ("fwd", "bwd") at T: its time a
    call, host dispatch and device time by op."""
    B, H, d = F_BWD_SHAPE
    print(f"  rel_attention_train_{direction} B={B} H={H} T={T} d={d} rate {F_RATE} bf16: "
          f"{r['ms']:.4f} ms a call ({r['host_ms']:.4f} ms of host dispatch), "
          f"{r['device_ms']:.4f} ms of device time by the profiler:")
    for name, (ms, n) in r["ops"].items():
        print(f"    {ms:9.4f} ms  x{n:<4d} {name}")


def check_train_kernels(torch, dev):
    """Phase 2b: kernels E and F, forward and backward, against their plain
    versions on the card at the training shapes (B = 12, T = 1024)."""
    from vispeech_tpu_torch.ops.kernels import rel_attention_train as F_
    from vispeech_tpu_torch.ops.kernels import wn_stack_train as E_

    gen = torch.Generator().manual_seed(SEED + 1)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = {}
    B, T, C, K = 12, 1024, 192, 5
    m = (torch.arange(T, device=dev)[None, :, None]
         < torch.tensor([T - 37 * (i % 3) for i in range(B)], device=dev)[:, None, None]).float()
    for L, label in ((16, "enc_q, speaker cond"), (4, "flow coupling")):
        w_rs = rn(L, C, 2 * C, scale=0.05)
        w_rs[-1, :, C:] = 0.0
        b_rs = rn(L, 1, 2 * C, scale=0.1)
        b_rs[-1, :, C:] = 0.0
        args = (rn(B, T, C), m, rn(B, L, 2 * C, scale=0.3), rn(L, K, C, 2 * C, scale=0.03),
                w_rs, b_rs)
        dout = rn(B, T, C)
        for bf16 in (False, True):
            dt = "bfloat16" if bf16 else "float32"
            print(f"kernel E wn_stack_train B={B} T={T} L={L} ({label}) {dt}:")
            out, xs = E_._launch_fwd(*args, K, bf16)
            ref, xs_ref = E_.wn_stack_train_plain_fwd(*args, K, bf16)
            _held(("fwd", ("out", "xs")), (out, xs), (ref, xs_ref), bf16)
            grads = E_._launch_bwd(dout, xs, *args[1:5], K, bf16)
            refs = E_.wn_stack_train_plain_bwd(dout, xs_ref, *args[1:5], K, bf16)
            err_b = _held(("bwd", ("dx", "dcond", "dW_in", "dW_rs", "db_rs")), grads, refs, bf16)
            if L != 16 or not bf16:
                continue
            # the main path's largest call: enc_q, bf16 operands; the forward
            # on the step's own operands at T = 1024 and two frame buckets
            checked = {T_: check_e_fwd(torch, dev, T_) for T_ in E_FWD_T}
            ops = e_step_operands(torch, dev, T)
            f32 = [t.float() for t in ops]
            plain = time_ms(lambda: E_.wn_stack_train_plain_fwd(*f32, K, bf16), 5)
            # every layer's gate and residual half, the skip half below the last
            flops = 2.0 * B * T * (L * K * C * 2 * C + (2 * L - 1) * C * C)
            b_ms, b_by = bound(nbytes(*ops, out, xs), flops, dt)
            rows["wn_stack_train_fwd"] = dict(max_abs_err=checked[T]["max_abs_err"],
                                              ms=checked[T]["ms"], plain_ms=plain,
                                              bound_ms=b_ms, bound_by=b_by)
            ms = time_ms(lambda: E_._launch_bwd(dout, xs, *args[1:5], K, bf16), 3)
            plain = time_ms(lambda: E_.wn_stack_train_plain_bwd(dout, xs_ref, *args[1:5], K,
                                                                bf16), 3)
            bwd_flops = 2.0 * B * T * L * (3 * K * C * 2 * C + 2 * C * 2 * C)
            b_ms, b_by = bound(nbytes(dout, xs, *args[1:5], *grads), bwd_flops, dt)
            rows["wn_stack_train_bwd"] = dict(max_abs_err=err_b, ms=ms, plain_ms=plain,
                                              bound_ms=b_ms, bound_by=b_by)
            for key in ("wn_stack_train_fwd", "wn_stack_train_bwd"):
                r = rows[key]
                print(f"  {key} L={L} {dt}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            # the backward's device time by sub-kernel, beside its total
            breakdown = e_bwd_breakdown(torch, dev)
            breakdown.pop("grads")
            print_e_bwd(breakdown)

    B, H, T, d = 12, 2, 1024, 96
    key_mask = (torch.arange(T, device=dev) < T - 37).float()[None].expand(B, T).contiguous()
    args = (rn(B, H, T, d), rn(B, H, T, d), rn(B, H, T, d), rn(1, 9, d, scale=d ** -0.5),
            rn(1, 9, d, scale=d ** -0.5), key_mask)
    dout = rn(B, H, T, d)
    for rate, bf16 in ((0.1, False), (0.0, False), (0.1, True)):
        dt = "bfloat16" if bf16 else "float32"
        print(f"kernel F rel_attention_train B={B} H={H} T={T} rate={rate} {dt}:")
        out, lse = F_._launch_fwd(*args, 99, rate, 4, bf16)
        ref, lse_ref = F_.relative_self_attention_train_plain_fwd(*args, 99, rate, 4, bf16)
        _held(("fwd", ("out", "lse")), (out, lse), (ref, lse_ref), bf16)
        grads = F_._launch_bwd(dout, *args, out, lse, 99, rate, 4, bf16)
        refs = F_.relative_self_attention_train_plain_bwd(dout, *args, lse_ref, 99, rate, 4,
                                                          bf16)
        _held(("bwd", ("dq", "dk", "dv", "drel_k", "drel_v")), grads, refs, bf16)
    # the bf16 forward and backward on the operands the training step hands
    # them (bf16 strided views), at T = 1024 and the main path's frame bucket
    # and phoneme length, each held to the plain version and timed by op
    checked_f = {T_: check_f_fwd(torch, dev, T_) for T_ in F_BWD_T}
    checked = {T_: check_f_bwd(torch, dev, T_) for T_ in F_BWD_T}
    x = f_bwd_inputs(torch, dev, T)
    f = [t.float() for t in x]
    plain = time_ms(lambda: F_.relative_self_attention_train_plain_fwd(
        *f[1:7], 99, F_RATE, 4, True), 5)
    # two T×T products: scores and p·v; out and lse f32
    b_ms, b_by = bound(nbytes(*x[1:7]) + B * H * T * (d + 1) * 4, 4.0 * B * H * T * T * d,
                       "bfloat16")
    rows["rel_attention_train_fwd"] = dict(max_abs_err=checked_f[T]["max_abs_err"],
                                           ms=checked_f[T]["ms"], plain_ms=plain, bound_ms=b_ms,
                                           bound_by=b_by)
    plain = time_ms(lambda: F_.relative_self_attention_train_plain_bwd(
        *f[:7], f[8], 99, F_RATE, 4, True), 5)
    # five T×T products: scores, dO·vᵀ, dv, dq, dk; out: dq, dk, dv and the rel tables' grads
    moved = nbytes(*x) + 3 * B * H * T * d * 4 + 2 * 9 * d * 4
    b_ms, b_by = bound(moved, 10.0 * B * H * T * T * d, "bfloat16")
    rows["rel_attention_train_bwd"] = dict(max_abs_err=checked[T]["max_abs_err"],
                                           ms=checked[T]["ms"], plain_ms=plain, bound_ms=b_ms,
                                           bound_by=b_by)
    for key in ("rel_attention_train_fwd", "rel_attention_train_bwd"):
        r = rows[key]
        print(f"  {key} T={T} bfloat16 rate 0.1: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def pinyin_text(n_syllables: int, offset: int = 0) -> str:
    syl = ["ni2", "hao3", "shi4", "jie4", "wo3", "men5", "zou3", "ba5", "zai4", "jian4",
           "xie4", "tian1", "qi4", "zhen1", "bu2", "cuo4", "chi1", "fan4", "le5", "ma5"]
    return "[P]" + " ".join(syl[(offset + i) % len(syl)] for i in range(n_syllables)) + "[P]"


def serving_requests(torch, cfg):
    """Phase 3's requests, as (label, ``synthesize`` kwargs, kernel A
    launches of the request): short with predicted durations, long with
    explicit durations filling the 1400-frame bucket, edited with pitch and
    energy arrays; and the 8 texts of its batch."""
    from vispeech_tpu_torch.text import text_to_phones

    n_attn = cfg.model.n_layers          # TextEncoder / FramePriorNet layers
    n_pitch = 6                          # PitchPredictor layers
    long_text = pinyin_text(35)
    n_long = len(text_to_phones(long_text))
    long_dur = [1400 // n_long + (i < 1400 % n_long) for i in range(n_long)]
    pe_text = pinyin_text(12, 5)
    n_pe = len(text_to_phones(pe_text))
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
    return requests, batch_texts


def serve(torch, dev, cfg, state_dict):
    """Phase 3: the engine at full width; returns the engine, the launch
    counts, the counts the path must make, and the requests."""
    import numpy as np

    from vispeech_tpu_torch.infer.batching import plan_batches
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops import kernels

    engine = TTSEngine(cfg, state_dict, device=dev.type, transfer_int16=True)
    hop, sr = cfg.data.hop_length, cfg.data.sampling_rate
    n_attn, n_pitch = cfg.model.n_layers, 6
    requests, batch_texts = serving_requests(torch, cfg)

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
    # kernels' build); the counted and timed pass comes after it, with the
    # (B, T) of every kernel C launch recorded
    from vispeech_tpu_torch.ops.kernels import mrf_stage

    run()
    c_shapes, wrapper = [], mrf_stage.mrf_stack

    def recorded(x, *args, **kwargs):
        if x.is_cuda:
            c_shapes.append(tuple(x.shape[:2]))
        return wrapper(x, *args, **kwargs)

    kernels.reset_launches()
    mrf_stage.mrf_stack = recorded
    try:
        results, latency, batch, batch_s = run()
    finally:
        mrf_stage.mrf_stack = wrapper
    counts = kernels.launch_counts()
    # the same run once more under the profiler: each kernel's summed device time
    totals = profile(torch, "serving run (3 requests + batch of 8)", run, 12)
    if "mrf_stage" in totals:
        print(f"  kernel C over the serving run: {totals['mrf_stage'][0]:.4f} ms of device time "
              f"in {len(c_shapes)} launches at (B, T) {c_shapes}")

    # serving runs under no_grad: the training kernels E and F never launch
    expect = {k: 0 for k in counts}
    expect.update({"rel_attention": sum(n_a for _, _, n_a in requests),
                   "wn_stack": 4 * len(requests), "mrf_stage": len(requests),
                   "mrf_stage_folded": len(requests)})
    n_list = [len(o["phones"]) for o in batch]
    frames = [max(int(o["duration"].sum()), 1) for o in batch]
    plans = plan_batches(frames)
    n_plans = len(plans)
    n_pads = len({min(-(-max(n, 1) // 32) * 32, engine.max_phonemes) for n in n_list})
    expect["rel_attention"] += n_attn * n_pads + (n_attn + n_pitch + n_attn) * n_plans
    expect["wn_stack"] += 4 * n_plans
    expect["mrf_stage"] += n_plans
    expect["mrf_stage_folded"] += n_plans

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
    print(f"synthesize_batch plans (tier, bucket): {[(p.tier, p.bucket) for p in plans]}")
    return engine, counts, expect, requests, plans


# the kernels' CUDA function names, as the profiler lists them (matched
# without their arguments: F's forward takes bwd16::Src operands): the
# serving kernels, and kernels E and F in training (forward; bf16 and f32
# backward)
KERNEL_FUNCS = {"rel_attention": ("rel_attention_",), "wn_stack": ("wn_stack_kernel",),
                "mrf_stage": ("mrf_stage_kernel",), "mrf_stage_folded": ("mrf_folded_kernel",),
                "wn_stack_train_fwd": ("fwd_layer<", "wf::"),
                "wn_stack_train_bwd": ("wg::",),
                "rel_attention_train_fwd": ("fwd16::", "fwd_kernel<"),
                "rel_attention_train_bwd": ("bwd16::", "bwd_q_kernel<", "bwd_kv_kernel<")}


def profile(torch, label, fn, top, record=None):
    """``fn()`` once under torch.profiler: the device's busy share of its
    wall time, the ``top`` device ops by time, and the summed device time of
    each kernel of ``KERNEL_FUNCS`` (phases 3, 3c, 3d and 4).  → {kernel:
    (ms, count)}; ``record`` (a dict) also gets the wall and busy ms."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not events:
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        print(f"profile {label}: wall {wall_ms:.2f} ms, device time not measured")
        return {}
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device ops")
    if record is not None:
        record.update(wall_ms=wall_ms, busy_ms=busy_ms)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    totals = {}
    for name, func in KERNEL_FUNCS.items():
        hits = [e for e in events if any(f in _op_name(e.key) for f in func)]
        totals[name] = (sum(e.self_device_time_total for e in hits) / 1e3,
                        sum(e.count for e in hits))
    print(f"  kernel device time over {label}: " + ", ".join(
        f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in totals.items()))
    # library work by kind: cuDNN's implicit-GEMM convs, the other GEMMs
    groups = {"implicit-GEMM convs": lambda k: "implicit_gemm" in k,
              "other GEMMs": lambda k: "gemm" in k.lower() and "implicit_gemm" not in k}
    print(f"  by kind over {label}: " + ", ".join(
        f"{name} {sum(e.self_device_time_total for e in events if hit(e.key)) / 1e3:.4f} ms "
        f"x{sum(e.count for e in events if hit(e.key))}" for name, hit in groups.items())
        + f", kernels A-F {sum(ms for ms, _ in totals.values()):.4f} ms of {busy_ms:.4f}")
    return totals


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


def voice_conversion_phase(torch, dev, cfg, state_dict, engine, wav):
    """Phase 3d: one VC request at full width on ``wav`` (the long request's
    1400 frames), through ``TTSEngine.voice_conversion``: the launch counts
    of its run, the audio, a profile, and the f32 conversion on the card
    against the plain f32 conversion on the CPU, posterior noise injected.
    → the launch counts."""
    import numpy as np

    from vispeech_tpu_torch.infer.batching import pick_bucket
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.ops.policy import FLOAT32

    hop, sr = cfg.data.hop_length, cfg.data.sampling_rate
    engine.voice_conversion(wav, 7, 99)        # meets the shapes once
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = engine.voice_conversion(wav, 7, 99)
    latency = time.perf_counter() - t0
    counts = kernels.launch_counts()
    frames = len(wav) // hop
    n = len(out["audio"])
    if n != frames * hop or not np.isfinite(out["audio"]).all():
        raise AssertionError(f"voice conversion: {n} samples for {frames} frames, finite "
                             f"{bool(np.isfinite(out['audio']).all())}")
    # the posterior encoder (L = 16) in B's per-layer mode, 4 couplings
    # forward and 4 in reverse; the decoder's C = 64 and C = 32 stages
    expect = {k: 0 for k in counts}
    expect.update(wn_stack=16 + 4 + 4, mrf_stage=1, mrf_stage_folded=1)
    print(f"voice conversion: {frames} frames, {n / sr:.3f} s audio, latency "
          f"{latency * 1e3:.2f} ms, {n / sr / latency:.2f} audio-s/s; launches {counts}, "
          f"expected {expect}")
    if counts != expect:
        raise AssertionError(f"voice conversion launch counts {counts} != {expect}")
    profile(torch, f"voice conversion ({frames} frames)",
            lambda: engine.voice_conversion(wav, 7, 99), 10)

    eps = torch.randn(1, pick_bucket(frames), cfg.model.inter_channels,
                      generator=torch.Generator().manual_seed(SEED)).numpy()
    outs = {}
    for name, device in (("kernels", dev.type), ("plain", "cpu")):
        f32 = TTSEngine(cfg, state_dict, device=device, policy=FLOAT32, transfer_int16=False)
        t0 = time.perf_counter()
        outs[name] = f32.voice_conversion(wav, 7, 99, eps=eps)["audio"]
        print(f"  f32 voice conversion ({name}) on {device}: {time.perf_counter() - t0:.2f} s")
        del f32
    err = float(abs(outs["kernels"] - outs["plain"]).max())
    peak = float(abs(outs["plain"]).max())
    ok = err <= 1e-3 * max(peak, 1e-3)
    print(f"reference: f32 voice conversion with kernels on the card vs plain f32 on the CPU: "
          f"{len(outs['plain'])} samples, max_abs_err {err:.3e}, peak {peak:.3e} "
          f"(tol 1e-3 of peak) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"f32 voice conversion on the card disagrees with the CPU: {err}")
    return counts


HTTP_WARM_PASSES = 4     # timed passes of phase 3e after the one that meets the shapes


def http_request(url, body=None, ctype="application/json"):
    """One request to the server → (status, content type, body, wall s); an
    error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST",
                                 headers={} if body is None else {"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, kind, data = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, kind, data = e.code, e.headers["Content-Type"], e.read()
    return status, kind, data, time.perf_counter() - t0


def concurrently(calls):
    """Each zero-argument call on a client thread of its own, all started
    together → (their results in order, wall s until the last returned)."""
    import threading

    results = [None] * len(calls)

    def run(i):
        results[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("an HTTP client thread did not finish")
    return results, time.perf_counter() - t0


def wav_pcm(label, answer, sr):
    """The int16 samples of a 200 answer holding 16-bit mono PCM WAV at
    ``sr``; raises otherwise."""
    import struct

    import numpy as np

    status, kind, body, _ = answer
    if status != 200 or kind != "audio/wav" or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise AssertionError(f"{label}: HTTP {status} {kind} {body[:80]!r}")
    fmt = struct.unpack("<IHHIIHH", body[16:36])
    n = struct.unpack("<I", body[40:44])[0]
    if fmt != (16, 1, 1, sr, 2 * sr, 2, 16) or len(body) != 44 + n:
        raise AssertionError(f"{label}: WAV header {fmt}, {n} data bytes of {len(body) - 44}")
    return np.frombuffer(body[44:], "<i2")


def http_phase(torch, dev, cfg, state_dict, requests, batch_texts):
    """Phase 3e: the port's HTTP server on the card.  The seeded weights go
    to a port ``ckpt_1.pt`` and a reference-style ``G_1.pth`` (``module.``
    prefix, dead keys); an engine from each through
    ``TTSEngine.from_checkpoint``, their state dicts equal; the first serves
    on port 0 with the coalescer (20 ms window, max_batch 16).  Over HTTP,
    from client threads, with the launch counters reset, twice (the
    server's threads meet the shapes in the first pass): the 8 batch texts
    at once; the short request with seed=5 amid 4 unseeded ones, alone, and
    at sr=22050; the edited request's pitch and energy arrays by POST;
    ``/tts.json`` of the long text, scaled into the 1400-frame bucket; the
    long request's audio through ``POST /vc``; a request over max_phonemes
    amid 3 good ones.  Then each request once more straight through the
    engine, timed beside its HTTP wall time; the short request and VC also
    straight through the engine on a thread of their own; and the short
    request and the edited one through a serial-mutex server.  → the
    launch counts over HTTP."""
    import json as _json
    import statistics
    import threading
    from urllib.parse import urlencode

    import numpy as np

    from vispeech_tpu_torch.dsp.resample import resample
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.infer.server import make_server, wav_bytes
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.utils.checkpoint import AsyncCheckpointer

    hop, sr = cfg.data.hop_length, cfg.data.sampling_rate
    hidden = cfg.model.hidden_channels
    root = tempfile.mkdtemp(prefix="vispeech_http_")
    try:
        port_dir, ref_dir = os.path.join(root, "port"), os.path.join(root, "reference")
        ckpt = AsyncCheckpointer()
        ckpt.save(port_dir, {"step": 1, "model_g": state_dict}, 1)
        ckpt.wait()
        dead = {"enc_p.proj.weight": torch.zeros(2 * cfg.model.inter_channels, hidden, 1),
                "frame_prior_net.emb.weight": torch.zeros(121, hidden),
                "energy_predictor.predictor.proj.weight": torch.zeros(hidden, 1)}
        os.makedirs(ref_dir)
        torch.save({"model": {"module." + k: v for k, v in {**state_dict, **dead}.items()},
                    "iteration": 1}, os.path.join(ref_dir, "G_1.pth"))
        config_path = os.path.join(ROOT, "configs", "config.json")
        t0 = time.perf_counter()
        engine = TTSEngine.from_checkpoint(config_path, port_dir, device=dev.type,
                                           transfer_int16=True)
        t1 = time.perf_counter()
        reference = TTSEngine.from_checkpoint(config_path, ref_dir, device=dev.type,
                                              transfer_int16=True)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = engine.model.state_dict(), reference.model.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the ckpt_1.pt and G_1.pth engines' state dicts differ")
    print(f"http: engines from ckpt_1.pt ({t1 - t0:.2f} s) and G_1.pth ({t2 - t1:.2f} s), "
          f"{len(a)} tensors equal")
    del a, b, reference

    short_kw, long_kw, edit_kw = (dict(kw) for _, kw, _ in requests)
    short_q = {"text": short_kw["text"], "speaker": short_kw["speaker"], "seed": 5}
    long_text, n_long = long_kw["text"], len(long_kw["duration_control"])
    big_text = pinyin_text(300)
    if len(engine.phonemes(big_text)) <= engine.max_phonemes:
        raise AssertionError("the oversized request is not over max_phonemes")
    edit_body = _json.dumps({"text": edit_kw["text"], "speaker": edit_kw["speaker"],
                             "seed": edit_kw["seed"],
                             "pitch": [float(x) for x in edit_kw["pitch_control"]],
                             "energy": [float(x) for x in edit_kw["energy_control"]]}).encode()
    # the engine meets every shape on this thread first: cuDNN plans, the
    # kernels' weights; the resampler's and the WAV reader's imports
    direct_batch = engine.synthesize_batch(texts=batch_texts, speakers=list(range(8)))
    frames8 = [int(o["duration"].sum()) for o in direct_batch]
    long_pcm = engine.synthesize(**long_kw)["audio_int16"]
    vc_body = wav_bytes(long_pcm, sr)
    vc_wav = long_pcm.astype(np.float32) / 32767.0
    engine.voice_conversion(vc_wav, 7, 99)
    engine.synthesize(**edit_kw)
    resample(engine.synthesize(**short_q)["audio"], sr, 22050)
    from scipy.io import wavfile  # noqa: F401
    torch.cuda.synchronize()

    def serve_on(window_ms):
        httpd, coalescer = make_server(engine, "127.0.0.1", 0, batch_window_ms=window_ms,
                                       max_batch=16)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        return httpd, coalescer, f"http://127.0.0.1:{httpd.server_address[1]}"

    def stop(httpd, coalescer):
        httpd.shutdown()
        httpd.server_close()
        if coalescer is not None:
            coalescer.close()

    def get(url, path, **q):
        return lambda: http_request(f"{url}{path}?{urlencode(q)}")

    def one_pass(url, coalescer):
        """Every request of the phase once → {name: answer or answers}."""
        out = {}
        n_groups = len(coalescer.batch_sizes)
        out["batch8"], out["batch8_s"] = concurrently(
            [get(url, "/tts", text=t, speaker=i) for i, t in enumerate(batch_texts)])
        out["groups8"] = coalescer.batch_sizes[n_groups:]
        out["amid"], _ = concurrently([get(url, "/tts", **short_q)] + [
            get(url, "/tts", text=t, speaker=i) for i, t in enumerate(batch_texts[:4])])
        out["alone"] = get(url, "/tts", **short_q)()
        out["half"] = get(url, "/tts", sr=22050, **short_q)()
        out["edited"] = http_request(f"{url}/tts", edit_body)
        out["plain_json"] = get(url, "/tts.json", text=long_text, speaker=17)()
        predicted = sum(_json.loads(out["plain_json"][2])["duration"]) \
            if out["plain_json"][0] == 200 else 1
        # ceil(d·s) per phoneme: s·Σd ≤ frames < s·Σd + n_long, inside (1280, 1400]
        out["scale"] = 1300.0 / predicted
        out["long_json"] = get(url, "/tts.json", text=long_text, speaker=17,
                               duration=out["scale"])()
        out["vc"] = http_request(f"{url}/vc?src=7&tgt=99", vc_body, "audio/wav")
        out["mixed"], _ = concurrently([get(url, "/tts", text=t, speaker=i)
                                        for i, t in enumerate(batch_texts[:2])]
                                       + [get(url, "/tts", text=big_text)]
                                       + [get(url, "/tts", text=batch_texts[2], speaker=2)])
        return out

    httpd, coalescer, url = serve_on(20.0)
    try:
        kernels.reset_launches()
        # pass 1 meets the shapes on the server's threads; the rest are timed warm
        passes = [one_pass(url, coalescer) for _ in range(1 + HTTP_WARM_PASSES)]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        stop(httpd, coalescer)
    served = [(k, counts[k]) for k in ("rel_attention", "wn_stack", "mrf_stage",
                                       "mrf_stage_folded")]
    idle = {k: v for k, v in counts.items() if "_train_" in k and v}
    print(f"http: launches over HTTP ({len(passes)} passes) {counts}")
    if any(n == 0 for _, n in served) or idle:
        raise AssertionError(f"over HTTP, A-D launches {served}, E/F launches {idle}")
    if not any(g >= 2 for g in coalescer.batch_sizes):
        raise AssertionError(f"no coalesced group of 2 or more: {coalescer.batch_sizes}")

    def timed(fn, reps=HTTP_WARM_PASSES):
        """(the last result, the wall s of each of ``reps`` calls)."""
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            walls.append(time.perf_counter() - t0)
        return out, walls

    scale = passes[-1]["scale"]
    direct = {"batch8": timed(lambda: engine.synthesize_batch(
        texts=batch_texts, speakers=list(range(8))))[1]}
    short_out, direct["short"] = timed(lambda: engine.synthesize(**short_q))
    direct["half"] = timed(lambda: resample(engine.synthesize(**short_q)["audio"], sr,
                                            22050))[1]
    edit_out, direct["edited"] = timed(lambda: engine.synthesize(**edit_kw))
    direct["long_json"] = timed(lambda: engine.synthesize(
        text=long_text, speaker=17, duration_control=scale))[1]
    direct["vc"] = timed(lambda: engine.voice_conversion(vc_wav, 7, 99))[1]

    def lsb(label, answer):
        pcm, ref = wav_pcm(label, answer, sr), short_out["audio_int16"]
        return int(np.abs(pcm.astype(np.int32) - ref).max()) if len(pcm) == len(ref) else None

    worst = 0
    for n, out in enumerate(passes, 1):
        audio_s = 0.0
        for i, ans in enumerate(out["batch8"]):
            pcm = wav_pcm(f"pass {n}: batch text {i}", ans, sr)
            if len(pcm) != frames8[i] * hop:
                raise AssertionError(f"pass {n}: batch text {i}: {len(pcm)} samples for "
                                     f"{frames8[i]} frames")
            audio_s += len(pcm) / sr
        out["audio_s"] = audio_s
        for i, ans in enumerate(out["amid"][1:]):
            wav_pcm(f"pass {n}: unseeded {i} beside seed=5", ans, sr)
        amid, alone = lsb(f"pass {n}: seed=5 amid", out["amid"][0]), \
            lsb(f"pass {n}: seed=5 alone", out["alone"])
        if amid is None or amid > 1 or alone is None or alone > 1:
            raise AssertionError(f"pass {n}: seeded PCM differs from the direct call: "
                                 f"{amid}, {alone} LSB")
        worst = max(worst, amid, alone)
        n22 = len(wav_pcm(f"pass {n}: seed=5 at sr=22050", out["half"], 22050))
        if abs(n22 - len(short_out["audio_int16"]) * 22050 / sr) > 2:  # half at 44.1 kHz
            raise AssertionError(f"pass {n}: sr=22050: {n22} samples")
        pcm = wav_pcm(f"pass {n}: POST edited", out["edited"], sr)
        if len(pcm) != len(edit_out["audio_int16"]):
            raise AssertionError(f"pass {n}: POST edited: {len(pcm)} samples, direct "
                                 f"{len(edit_out['audio_int16'])}")
        for label in ("plain_json", "long_json"):
            if out[label][0] != 200:
                raise AssertionError(f"pass {n}: {label}: HTTP {out[label][0]} "
                                     f"{out[label][2][:200]!r}")
        body = _json.loads(out["long_json"][2])
        out["frames"] = frames = int(sum(body["duration"]))
        if not (len(body["phones"]) == len(body["duration"]) == len(body["f0"])
                == len(body["energy"]) == n_long) or not 1280 < frames <= 1400 \
                or body["n_samples"] != frames * hop \
                or not np.isfinite(body["f0"] + body["energy"]).all():
            raise AssertionError(f"pass {n}: /tts.json long: {len(body['phones'])} phones, "
                                 f"{frames} frames, {body['n_samples']} samples")
        if len(wav_pcm(f"pass {n}: POST /vc", out["vc"], sr)) != 1400 * hop:
            raise AssertionError(f"pass {n}: POST /vc is not 1400 frames")
        statuses = [ans[0] for ans in out["mixed"]]
        error = out["mixed"][2][2][:200]
        if statuses[:2] + statuses[3:] != [200] * 3 or statuses[2] < 400 \
                or b"too many phonemes" not in error:
            raise AssertionError(f"pass {n}: the oversized request did not fail alone: "
                                 f"{statuses} {error!r}")
        for i in (0, 1, 3):
            wav_pcm(f"pass {n}: good {i} beside the oversized", out["mixed"][i], sr)
    print(f"http: seed=5 amid 4 unseeded and alone vs engine.synthesize(seed=5), every pass: "
          f"{len(short_out['audio_int16'])} samples, max diff {worst} LSB (limit 1)")
    print(f"http: oversized amid 3 good ones, every pass: statuses {statuses}, error {error!r}")

    # the same calls straight through the engine on threads that never met
    # their shapes (the server's handler threads are such threads)
    fresh = {name: [concurrently([lambda: timed(fn, 1)[1][0]])[0][0] for _ in range(3)]
             for name, fn in (("short", lambda: engine.synthesize(**short_q)),
                              ("vc", lambda: engine.voice_conversion(vc_wav, 7, 99)))}
    # the serial-mutex server (batch window 0): its worker thread meets the
    # shapes in the first call of each request
    httpd, _, url = serve_on(0.0)
    try:
        mutex = {"short": [get(url, "/tts", **short_q)() for _ in range(1 + HTTP_WARM_PASSES)],
                 "edited": [http_request(f"{url}/tts", edit_body)
                            for _ in range(1 + HTTP_WARM_PASSES)]}
    finally:
        stop(httpd, None)
    for name, answers in mutex.items():
        for ans in answers:
            wav_pcm(f"mutex server: {name}", ans, sr)

    def ms(walls):
        return f"{1e3 * statistics.median(walls):.2f} (min {1e3 * min(walls):.2f})"

    warm = passes[1:]
    rows = [("the 8 at once (each answer's wall: the slowest)",
             [p["batch8_s"] for p in passes], "batch8"),
             ("seed=5 amid 4 unseeded", [p["amid"][0][3] for p in passes], "short"),
             ("seed=5 alone", [p["alone"][3] for p in passes], "short"),
             ("seed=5 at sr=22050 (+ resample)", [p["half"][3] for p in passes], "half"),
             ("POST /tts edited (pitch, energy arrays)", [p["edited"][3] for p in passes],
              "edited"),
             (f"/tts.json long, {passes[-1]['frames']} frames",
              [p["long_json"][3] for p in passes], "long_json"),
             ("POST /vc, 1400 frames", [p["vc"][3] for p in passes], "vc"),
             ("mutex server: seed=5 alone", [a[3] for a in mutex["short"]], "short"),
             ("mutex server: POST /tts edited", [a[3] for a in mutex["edited"]], "edited")]
    print(card_line())
    print(f"http rows: wall ms over HTTP of the first call (the server's thread meets the "
          f"shapes), then the median (min) of {len(warm)} warm calls; the same request "
          f"straight through the engine on this thread, median (min) of {HTTP_WARM_PASSES}; "
          f"the medians' difference")
    for label, walls, key in rows:
        d = direct[key]
        print(f"http '{label}': first {1e3 * walls[0]:.2f}, warm {ms(walls[1:])} ms over HTTP, "
              f"{ms(d)} ms straight through the engine, "
              f"+{1e3 * (statistics.median(walls[1:]) - statistics.median(d)):.2f} ms")
    print(f"http: straight through the engine on a new thread (3 each): seed=5 "
          f"{ms(fresh['short'])} ms (on this thread {ms(direct['short'])}), VC "
          f"{ms(fresh['vc'])} ms (on this thread {ms(direct['vc'])})")
    audio_s = passes[0]["audio_s"]
    print(f"http: the 8 at once in coalesced groups {[p['groups8'] for p in passes]}; "
          f"{audio_s:.3f} s audio: first {audio_s / passes[0]['batch8_s']:.2f}, warm median "
          f"{audio_s / statistics.median(p['batch8_s'] for p in warm):.2f} audio-s/s over HTTP; "
          f"synthesize_batch straight {audio_s / statistics.median(direct['batch8']):.2f}")
    print(f"http: every synthesize_batch group {coalescer.batch_sizes}")
    del engine
    return counts


TRAIN_SEED = 4321


def _corpus(root, cfg, n_utts=24):
    """A synthetic corpus at the config's rate and hop, frame lengths
    spread over the 512-1024 buckets; → the config pointed at it."""
    import dataclasses

    from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset

    d = cfg.data
    train_list, val_list, data_root = write_synthetic_dataset(
        root, d.sampling_rate, d.hop_length, n_utts=n_utts, dur_range=(4, 10),
        n_phones_choices=(80, 95, 110, 125), seed=TRAIN_SEED)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(d, training_files=train_list,
                                      validation_files=val_list),
        train=dataclasses.replace(cfg.train, save_dir=os.path.join(root, "run"),
                                  log_interval=1, eval_interval=10 ** 6))
    return cfg, data_root


def _param_snapshot(model):
    return {n: p.detach().float().clone() for n, p in list(model.named_parameters())[::7]}


def train_phase(torch, cfg, root, record=None):
    """Phase 4: the Trainer at full width (batch 12, bf16 tail_f32): one
    warm-up step, 5 timed steps with the launch counters, a profiled step,
    the losses and parameter updates, a checkpoint and a resumed Trainer.
    → the launch counts of the 5 timed steps; ``record`` (a dict) also gets
    the step times, the profiled step's frames, wall and busy ms and the
    kernels' device time in it."""
    import numpy as np

    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.train.loop import Trainer

    cfg, data_root = _corpus(root, cfg)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data_root=data_root)
    print(f"train: Trainer built in {time.perf_counter() - t0:.2f} s: "
          f"{len(trainer.train_set)} utterances, {trainer.steps_per_epoch} steps/epoch, "
          f"bf16 stages {trainer.model_g.bf16_stages}, TF32 {trainer.step_fn.tf32}")
    g0, d0 = _param_snapshot(trainer.model_g), _param_snapshot(trainer.model_d)
    t0 = time.perf_counter()
    trainer.train(max_steps=1)   # the user's entry point; writes ckpt_1.pt
    torch.cuda.synchronize()
    print(f"train: warm-up step (and checkpoint) {time.perf_counter() - t0:.2f} s")

    d = cfg.data
    batches = (batch for _, batch in trainer.batches(start_epoch=1))
    times, audio_s, seg_s, all_metrics = [], 0.0, 0.0, []
    kernels.reset_launches()
    for _ in range(5):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step_fn(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
        audio_s += float(batch["spec_lengths"].sum()) * d.hop_length / d.sampling_rate
        seg_s += batch["wav"].shape[0] * cfg.train.segment_size / d.sampling_rate
        print(f"  step {trainer.global_step}: batch {tuple(batch['wav'].shape[:2])} "
              f"({batch['wav'].shape[1] // d.hop_length} frames), {times[-1] * 1e3:.2f} ms, "
              f"g={all_metrics[-1]['loss/g/total']:.3f} d={all_metrics[-1]['loss/d/total']:.3f} "
              f"mel={all_metrics[-1]['loss/g/mel']:.3f}")
    counts = kernels.launch_counts()
    total = sum(times)
    print(f"train: 5 steps in {total:.4f} s: {1e3 * total / 5:.2f} ms/step, "
          f"{5 / total:.3f} steps/s, {audio_s / total:.2f} utterance audio-s/s "
          f"({seg_s / total:.2f} s of decoded segments per s)")
    for m in all_metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite training metrics: {bad}")
    per_step = {"wn_stack_train_fwd": 5, "wn_stack_train_bwd": 5,
                "rel_attention_train_fwd": 14, "rel_attention_train_bwd": 14}
    expect = {k: 5 * v for k, v in per_step.items()}
    expect.update(rel_attention=0, wn_stack=0, mrf_stage=0, mrf_stage_folded=0)
    print(f"train launches over 5 steps: {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"training launch counts {counts} != {expect}")

    batch = next(batches)
    batches.close()
    prof = {}
    frames = batch['wav'].shape[1] // d.hop_length
    totals = profile(torch, f"train step ({frames} frames)", lambda: trainer.step_fn(batch), 12,
                     prof)
    if record is not None:
        record.update(step_ms=[1e3 * t for t in times],
                      median_step_ms=1e3 * sorted(times)[len(times) // 2],
                      profiled_frames=frames, profiled=prof, kernels=totals)
    moved_g = any(not torch.equal(v, p) for v, p in zip(
        g0.values(), _param_snapshot(trainer.model_g).values()))
    moved_d = any(not torch.equal(v, p) for v, p in zip(
        d0.values(), _param_snapshot(trainer.model_d).values()))
    if not (moved_g and moved_d):
        raise AssertionError(f"parameters did not move: G {moved_g}, D {moved_d}")

    target = trainer.global_step + 1
    trainer.train(max_steps=target)   # one more step through the entry point, then save
    path = os.path.join(cfg.train.save_dir, f"ckpt_{target}.pt")
    if not os.path.exists(path):
        raise AssertionError(f"no checkpoint at {path}")
    fresh = Trainer(cfg, data_root=data_root)
    resumed = fresh.resume()
    if resumed != target:
        raise AssertionError(f"resumed at step {resumed}, expected {target}")
    w_a = trainer.model_g.dec.conv_post.weight
    if not torch.equal(w_a, fresh.model_g.dec.conv_post.weight):
        raise AssertionError("the resumed generator differs from the saved one")
    fresh.train(max_steps=target + 1)
    if fresh.global_step != target + 1 or not os.path.exists(
            os.path.join(cfg.train.save_dir, f"ckpt_{target + 1}.pt")):
        raise AssertionError("the resumed Trainer did not take and save one more step")
    print(f"train: checkpoint ckpt_{target}.pt written, a fresh Trainer resumed at step "
          f"{resumed} and saved ckpt_{target + 1}.pt; losses finite, G and D moved")
    del trainer, fresh
    torch.cuda.empty_cache()
    return counts


TRAIN_REF_TOL = 1e-4


def train_reference(torch, cfg):
    """Phase 4b: one f32 train step at reduced depth and batch, kernels E
    and F on the card against the plain versions on the host CPU: same
    weights, dropout off, the posterior noise and segment starts injected,
    TF32 off.  Every loss and both gradient norms within ``TRAIN_REF_TOL``
    relative (f32 summation order through 16 + 16 WN layers, the decoder
    and six discriminators, in both backward passes).  A control step on
    the card with the bf16 stages on must miss that limit: it shows the
    check sees a fault of bf16 rounding's size in the assembled step."""
    import dataclasses

    from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
    from vispeech_tpu_torch.text import N_SYMBOLS
    from vispeech_tpu_torch.train.step import TrainStep

    cfg_bf16 = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=2),
        model=dataclasses.replace(cfg.model, n_layers=2))
    cfg = dataclasses.replace(cfg_bf16, train=dataclasses.replace(cfg_bf16.train,
                                                                  fp16_run=False))
    B, N, T, hop = 2, 40, 200, cfg.data.hop_length
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    dur = torch.randint(3, 7, (B, N), generator=gen)
    dur[:, -1] = T - dur[:, :-1].sum(1)
    dur[1, -5:] = 0
    lengths = dur.sum(1)
    wav = torch.zeros(B, T * hop, 1, dtype=torch.int16)
    for b in range(B):
        n = int(lengths[b]) * hop
        wav[b, :n, 0] = (torch.randn(n, generator=gen) * 3000).to(torch.int16)
    batch = dict(phonemes=torch.randint(1, N_SYMBOLS, (B, N), generator=gen),
                 phoneme_lengths=torch.tensor([N, N - 5]),
                 f0=100 + 200 * torch.rand(B, N, generator=gen),
                 energy=30 + 60 * torch.rand(B, N, generator=gen), duration=dur, spec=None,
                 spec_lengths=lengths, wav=wav, wav_lengths=lengths * hop,
                 sid=torch.tensor([3, 17]))
    eps = torch.randn(B, T, cfg.model.inter_channels, generator=gen)
    ids = torch.tensor([5, 60])
    g_sd = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), TRAIN_SEED).state_dict()
    d_sd = random_init_(MultiPeriodDiscriminator(), TRAIN_SEED + 1).state_dict()
    out = {}
    for name, device, c in (("kernels", "cuda", cfg), ("plain", "cpu", cfg),
                            ("control, bf16 stages", "cuda", cfg_bf16)):
        g = Synthesizer.from_config(c, N_SYMBOLS)
        g.load_state_dict(g_sd)
        dd = MultiPeriodDiscriminator()
        dd.load_state_dict(d_sd)
        g, dd = g.to(device).eval(), dd.to(device).eval()
        step = TrainStep(c, g, dd, steps_per_epoch=10, tf32=False)
        t0 = time.perf_counter()
        m = step({k: None if v is None else v.to(device) for k, v in batch.items()},
                 eps_q=eps.to(device), ids_slice=ids.to(device))
        out[name] = {k: float(v) for k, v in m.items()}
        print(f"reference train step ({name}) on {device}: {time.perf_counter() - t0:.2f} s")
        del g, dd, step

    def worst(name):
        rels = {k: abs(out[name][k] - want) / max(abs(want), 1e-6)
                for k, want in out["plain"].items()}
        for k, rel in rels.items():
            print(f"    {name} {k}: card {out[name][k]:.6g}, cpu {out['plain'][k]:.6g}, "
                  f"rel {rel:.2e} {'ok' if rel <= TRAIN_REF_TOL else 'over'}")
        return max(rels.values())

    sound, control = worst("kernels"), worst("control, bf16 stages")
    print(f"reference: f32 train step with kernels E and F on the card vs plain on the CPU: "
          f"{len(out['plain'])} losses and norms, worst relative difference {sound:.2e}; "
          f"control with the bf16 stages on: {control:.2e} (tol {TRAIN_REF_TOL:.0e}) "
          f"{'ok' if sound <= TRAIN_REF_TOL < control else 'FAIL'}")
    if sound > TRAIN_REF_TOL:
        raise AssertionError(f"f32 train step differs by {sound:.2e} (tol {TRAIN_REF_TOL:.0e})")
    if control <= TRAIN_REF_TOL:
        raise AssertionError(f"the bf16 control step is within the limit ({control:.2e}): "
                             f"the check cannot see a fault of its size")


def seeded_state_dict(torch, cfg) -> dict:
    """The serving phases' weights: drawn from ``SEED`` at the config's
    width, the duration head biased, since random weights predict
    meaningless durations, so a phoneme lasts about e^1.8 − 1 ≈ 5 frames."""
    from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
    from vispeech_tpu_torch.text import N_SYMBOLS

    model = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed=SEED)
    with torch.no_grad():
        model.duration_predictor.proj.weight.mul_(0.1)
        model.duration_predictor.proj.bias.fill_(1.8)
    return model.state_dict()


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
    from vispeech_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    if sys.argv[1:] == ["--http"]:
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
        counts = http_phase(torch, dev, cfg, seeded_state_dict(torch, cfg),
                            *serving_requests(torch, cfg))
        print(json.dumps({"root": ROOT, "card": card_line(), "launches": counts}))
        return 0
    if sys.argv[1:] == ["--kernel-times"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"root": ROOT, "card": card_line(), "ms": kernel_times(torch, dev)}))
        return 0
    if sys.argv[1:] == ["--e-fwd"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        r = e_fwd_breakdown(torch, dev)
        r.pop("grads")
        print_e_fwd(E_BWD_SHAPE[1], r)
        print(json.dumps({"root": ROOT, "card": card_line(), **r}))
        return 0
    if sys.argv[1:] == ["--train"]:
        rec = {}
        root = tempfile.mkdtemp(prefix="vispeech_train_")
        try:
            train_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")), root,
                        rec)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"root": ROOT, "card": card_line(), **rec}))
        return 0
    if sys.argv[1:] == ["--e-bwd"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        r = e_bwd_breakdown(torch, dev)
        r.pop("grads")
        print_e_bwd(r)
        print(json.dumps({"root": ROOT, "card": card_line(), **r}))
        return 0
    if sys.argv[1:] == ["--f-fwd"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        by_t = {}
        for T in F_BWD_T:
            r = f_fwd_breakdown(torch, dev, T)
            r.pop("grads")
            print_f("fwd", T, r)
            by_t[T] = r
        print(json.dumps({"root": ROOT, "card": card_line(), "T": by_t}))
        return 0
    if sys.argv[1:] == ["--f-bwd"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        by_t = {}
        for T in F_BWD_T:
            r = f_bwd_breakdown(torch, dev, T)
            r.pop("grads")
            print_f("bwd", T, r)
            by_t[T] = r
        print(json.dumps({"root": ROOT, "card": card_line(), "T": by_t}))
        return 0
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} kernels compiled in {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}")
        # ptxas's warnings that it serialized a kernel's wgmma (C75xx)
        for ln in log.splitlines():
            if "C75" in ln:
                print(f"  {name} ptxas: {ln.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = check_kernels(torch, dev)
    rows.update(check_train_kernels(torch, dev))

    cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
    state_dict = seeded_state_dict(torch, cfg)
    engine, counts, expect, requests, plans = serve(torch, dev, cfg, state_dict)
    print(f"launches on the main path: {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    # kernel C at the largest batched plan the serving run launched
    plan = max(plans, key=lambda p: (p.tier > 1, p.tier * p.bucket))
    check_mrf(torch, dev, [(plan.tier, plan.bucket * MRF_SAMPLES)])
    for label, kw, _ in requests[:2]:
        engine.synthesize(**kw)
        profile(torch, f"'{label}'", lambda: engine.synthesize(**kw), 8)
    reference_check(torch, dev, cfg, state_dict)
    long_audio = engine.synthesize(**requests[1][1])["audio"]
    vc_counts = voice_conversion_phase(torch, dev, cfg, state_dict, engine, long_audio)
    del engine
    torch.cuda.empty_cache()
    http_counts = http_phase(torch, dev, cfg, state_dict, *serving_requests(torch, cfg))
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="vispeech_train_")
    try:
        train_counts = train_phase(torch, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train_reference(torch, cfg)

    # A, B, C and D count the serving run, the VC run and the HTTP phase; the
    # training run E and F
    counts = {k: v + vc_counts[k] + http_counts[k] for k, v in counts.items()}
    counts.update({k: v for k, v in train_counts.items() if "_train_" in k})
    kernels = [dict(name=name, route="cuda",
                    source=f"vispeech_tpu_torch/csrc/{name.rsplit('_', 1)[0] if '_train_' in name else name}.cu",
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
