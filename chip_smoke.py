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
3f. Raw text in (also alone as ``--text``): after 3d, on the engine of
   phase 3 behind a server of 3e's kind, with the golden corpus's zh and
   en lexicons (``tests/test_text.py``) loaded through the port's
   ``load_zh_lexicon`` and ``load_en_lexicon``.  Prints which of jieba,
   pypinyin, pyopenjtalk and g2p_en are importable.  For an ``[EN]``
   block, unfenced English with punctuation, a ``[P]`` block followed by
   ``[EN]`` and, where jieba is importable, the golden Mandarin
   date-and-temperature string (its phones the golden ones): phones equal
   to ``text_to_phones``, the engine's int16 PCM at a fixed seed equal to
   ``synthesize(phones=…)`` to 0 LSB, ``GET /tts`` within 1 LSB of it,
   ``/tts.json``'s phones the same, A-D launching and E/F not, through the
   engine and over HTTP.  Without jieba a hanzi text and a digit text
   answer 400 over HTTP and raise ImportError through the engine.  Prints
   each text's ``text_to_phones`` host time (median of 20) beside the
   request's engine and HTTP wall time (medians of 5).
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
4c. The Trainer (also alone as ``--trainer``): a full-width ``Trainer``
   (batch 12, tail_f32) on phase 4's corpus with its validation list,
   evals at steps 2 and 4, step 2 traced (``profile_steps``).  Prints which
   of tensorboardX, matplotlib and soundfile are importable; checks the
   run directory (config.json read back, githash in a git checkout, tb/,
   tb_eval/ and the evals' audio where TensorBoard cannot take it), A-D's
   launches (14/4/1/1 an eval), the trace file and E's and F's kernels in
   it; prints the trace's size and the traced step's peak memory.  One
   eval: wall time on the model in training and on a copy with frozen
   weight norms, device time (profiled), launches, its audio at noise 0
   against a CPU copy with the unfolded f32 decoder (1e-3 of the peak), and
   its FLOPs (``utils/flops.model_cost`` on that CPU copy) with
   ``roofline_row`` against ``chip_peaks()`` (f32).
4d. One batch of 12 of 4c's corpus through a ``TrainStep`` for f32,
   tail_f32, bf16_disc, bf16_only [dec], stable and full on 4c's weights,
   two passes in turns of a warm-up and 3 timed steps: E and F's launches,
   finite losses, the median of 6; a tail_f32 and a bf16_disc step
   profiled, with the scale discriminator's grouped-conv input gradient;
   a tail_f32 step's FLOPs (counted on CPU copies at batches 1 and 2,
   extrapolated to 12) and its ``roofline_row`` (bf16).
4e. The data axis (also alone as ``--ddp``): a 1-rank NCCL group in this
   process and the full-width Trainer on it against the one-process
   Trainer over 3 steps (parameters bit-equal), E's and F's launches a
   step, a profiled step's NCCL kernels (none: a world of one skips the
   gradient all-reduce), that all-reduce alone as a larger world runs it,
   and the step's wall time in turns; then ``torchrun --nproc_per_node 1``
   through the CLI to step 2 and resumed to step 4, its checkpoint served
   by ``TTSEngine.from_checkpoint``.
4f. The training decoder's fold (also alone as ``--fold``): the C = 64
   and C = 32 MRF stages at batch 12 and a 16 384-sample segment, folded
   against plain ResBlock1, forward + backward: gradients held in f64,
   device time in bf16 and f32.
4g. The model axis (also alone as ``--tp``): a (data 1 × model 2) world of
   two processes on the one card over gloo (NCCL refuses two ranks on one
   device), full width, batch 12, phase 4's corpus: which gloo collectives
   take CUDA tensors; 3 Trainer steps in f32 (TF32 off) and in tail_f32
   against one process's (step 1's losses and grad norms, in f32 every
   gradient gathered; then the losses and grad norms, and in f32 the
   parameters gathered, against a control), the ranks with the trainer's own cuDNN
   settings, their metrics and replicated parameters bit-equal; E's and
   F's launches on each rank; the model
   group's eval (A-D on each rank) against one process's on the gathered
   weights; the bytes a rank sends in a step, counted at the collectives,
   with their NVLink bound; rank 0's profiled step; then ``torchrun
   --nproc_per_node 1 ... --model-parallel 1`` through the CLI.
4h. Inference across devices (also alone as ``--cp``; ``cp_phase``): a
   world of two processes on the one card over gloo, full width: gloo's
   verdict on CUDA tensors handed to its send/recv as they are; ring
   attention (P = 2) at the FramePriorNet's shapes against kernel A; the
   overlap-save vocoder (P = 2) in bf16 and f32 against one process's
   whole decode, C and D on each rank; the two-stage pipeline at M = 2 and
   4 against one process's ``infer``, A on rank 0 and B, C, D on rank 1;
   the bytes each rank sends and each call's wall time (gloo's host
   staging); then the ring and the vocoder on a 1-rank NCCL world under
   ``torchrun`` (``--cp-nccl``).
4i. The stochastic duration predictor (also alone as ``--sdp``;
   ``sdp_phase``): ``configs/config.json`` with ``model.use_sdp`` set true
   in memory, ``seeded_state_dict``'s weights (the SDP biased so that a
   phoneme lasts a few frames), f32 with TF32 off, the long request's 68
   phonemes: the SDP's sampling and NLL on the card against the CPU with
   injected noise; ``Synthesizer.infer`` with a scalar duration control
   and injected noise (A 14, B 4, C 1, D 1; durations and audio against
   the CPU's); the engine's int16 PCM with ``use_sdp`` true and false
   (bit-equal); the Conformer, Decoder and FFT at hidden 192 over a
   [2, 1400] batch against the CPU; the SDP's and the deterministic
   head's wall and device busy time for one request.
5. Prints the per-kernel JSON line (A-D's launches over phases 3, 3d, 3f,
   3e, 4c, 4g's eval on rank 0, both ranks of 4h and 4i, E's and F's over
   phases 4, 4e and 4g's rank 0), the card's name and power limit, and
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

    python3 chip_smoke.py --trainer

runs phases 4c and 4d alone and prints their records as one JSON line
last.

    python3 chip_smoke.py --ddp
    python3 chip_smoke.py --fold
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --cp
    python3 chip_smoke.py --sdp

run phase 4e, 4f, 4g, 4h or 4i alone and print its record as one JSON
line last.

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

    python3 chip_smoke.py --text

runs phase 3f alone (the kernels built first, on an engine of phase 3's
weights) and prints its launch counts and times as one JSON line last.

    python3 chip_smoke.py --kernel-times

prints only the times of kernels A and B at phase 2's shapes, of C in
bf16 at ``MRF_TIMED`` and of D in bf16 at ``FOLDED_TIMED`` (C's and D's
kernel alone too, from the profiler), as one JSON line, for the checkout this file sits in: a copy of this file in
another checkout of the port times that one, so two versions compare
within one run.
"""

from __future__ import annotations

import dataclasses
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


def profile(torch, label, fn, top, record=None, match=None):
    """``fn()`` once under torch.profiler: the device's busy share of its
    wall time, the ``top`` device ops by time, and the summed device time of
    each kernel of ``KERNEL_FUNCS`` (phases 3, 3c, 3d and 4).  → {kernel:
    (ms, count)}; ``record`` (a dict) also gets the wall and busy ms, and
    under "matched" the summed (ms, count) of the device ops whose name
    holds each text of ``match`` ({name: text})."""
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
        record["matched"] = {
            name: (sum(e.self_device_time_total for e in events if text in e.key) / 1e3,
                   sum(e.count for e in events if text in e.key))
            for name, text in (match or {}).items()}
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


# phase 3f: the golden corpus's lexicons (tests/test_text.py,
# TestGoldenAdversarialCorpus) and its date-and-temperature string
TEXT_ZH_LEX = """借 jie4
还款 huan2 kuan3
他 ta1
只是 zhi3 shi4
一个 yi2 ge4
纸老虎 zhi3 lao3 hu3
开户行 kai1 hu4 hang2
奥 ao4
大家 da4 jia1
好 hao3
三十三 san1 shi2 san1
三 san1
啊 a1
我 wo3
是 shi4
萨达撒 sa4 da2 sa1
一二三 yi1 er4 san1
至 zhi4
但是 dan4 shi4
嗯 en1
什么 shen2 me5
东西 dong1 xi1
沉甸甸 chen2 dian1 dian1
的 de5
下午 xia4 wu3
一点 yi1 dian3
今天 jin1 tian1
五分之 wu3 fen1 zhi1
二千零二十二 er4 qian1 ling2 er4 shi2 er4
每 mei3
十 shi2
早上 zao3 shang4
二零二零年 er4 ling2 er4 ling2 nian2
十月 shi2 yue4
二十九日 er4 shi2 jiu3 ri4
最低 zui4 di1
温度 wen1 du4
负 fu4
度 du4
扎堆儿 zha1 duir1
"""
TEXT_EN_LEX = """ab AE1 B
s EH1 S
abst AE1 B S T
a EY1
b B IY1
c S IY1
d D IY1
"""
TEXT_GOLDEN_ZH = ("早上好，今天是2020/10/29，最低温度是-3°C。", [
    "z", "ao3", "sh", "ang4", "h", "ao3", ",", "j", "in1", "t", "ian1",
    "sh", "iii4", "er4", "l", "ing2", "er4", "l", "ing2", "n", "ian2",
    "sh", "iii2", "ve4", "er4", "sh", "iii2", "j", "iou3", "r", "iii4",
    ",", "z", "uei4", "d", "i1", "uen1", "d", "u4", "sh", "iii4",
    "f", "u4", "s", "an1", "S", "IY1", ".",
])
# raw texts that need no jieba: English through the en lexicon, in a block,
# unfenced with punctuation, and after a pinyin block
TEXT_PLAIN = ("[EN]ab c, d![EN]", "ab c, d!", "[P]ni3 hao3 shi4 jie4[P][EN]abst a b c[EN]")
TEXT_SEED, TEXT_SPEAKER = 7, 3
TEXT_G2P_PACKAGES = ("jieba", "pypinyin", "pyopenjtalk", "g2p_en")


def text_phase(torch, cfg, engine) -> tuple:
    """Phase 3f: raw text in, through the engine and a server of phase 3e's
    kind (coalescer, 20 ms window) on it.  The golden corpus's zh and en
    lexicons are loaded through the port's frontends (and unloaded after).
    For each text: its phones equal ``text_to_phones``; the engine's int16
    PCM at a fixed seed equals ``synthesize(phones=…)`` of those phones to
    0 LSB, and ``GET /tts`` with that seed is within 1 LSB of it; A-D
    launch and E/F do not.  With jieba the golden Mandarin string gives
    the golden phones; without it a hanzi text and a digit text answer 400
    over HTTP and raise ImportError through the engine.  Prints the host
    time of ``text_to_phones`` (median of 20) beside the engine's and the
    server's time for the request.  → (the launch counts of the phase, a
    row of times for each text)."""
    import importlib.util
    import statistics
    import threading
    from urllib.parse import urlencode

    import numpy as np

    from vispeech_tpu_torch.infer.server import make_server
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.text import frontends, text_to_phones

    present = {m: importlib.util.find_spec(m) is not None for m in TEXT_G2P_PACKAGES}
    print(f"text: optional G2P packages importable here: {present}")
    texts = list(TEXT_PLAIN) + ([TEXT_GOLDEN_ZH[0]] if present["jieba"] else [])
    refused = [] if present["jieba"] else [TEXT_GOLDEN_ZH[0], "33"]
    sr = cfg.data.sampling_rate
    saved = (dict(frontends._ZH_LEXICON), frontends._ZH_LEX_MAXLEN,
             dict(frontends._EN_LEXICON))
    root = tempfile.mkdtemp(prefix="vispeech_text_")
    httpd = coalescer = None
    try:
        for name, body, load in (("zh.lex", TEXT_ZH_LEX, frontends.load_zh_lexicon),
                                 ("en.lex", TEXT_EN_LEX, frontends.load_en_lexicon)):
            path = os.path.join(root, name)
            with open(path, "w", encoding="utf-8") as f:
                f.write(body)
            load(path)
        httpd, coalescer = make_server(engine, "127.0.0.1", 0, batch_window_ms=20.0,
                                       max_batch=16)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        query = dict(speaker=TEXT_SPEAKER, seed=TEXT_SEED)

        def say(text):
            return engine.synthesize(text=text, speaker=TEXT_SPEAKER, seed=TEXT_SEED)

        total = {}
        rows = []
        for text in texts:
            phones = text_to_phones(text)
            if text == TEXT_GOLDEN_ZH[0] and phones != TEXT_GOLDEN_ZH[1]:
                raise AssertionError(f"text: golden Mandarin phones {phones}")
            say(text)                        # meets the shapes
            torch.cuda.synchronize()
            kernels.reset_launches()
            out = say(text)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            same = engine.synthesize(phones=phones, speaker=TEXT_SPEAKER, seed=TEXT_SEED)
            if out["phones"] != phones or same["phones"] != phones:
                raise AssertionError(f"text {text!r}: phones {out['phones']} != {phones}")
            pcm, ref = out["audio_int16"], same["audio_int16"]
            if len(pcm) != len(ref) or not np.array_equal(pcm, ref) or not len(pcm):
                raise AssertionError(f"text {text!r}: PCM differs from synthesize(phones=)")
            kernels.reset_launches()
            ans = http_request(f"{url}/tts?{urlencode(dict(text=text, **query))}")
            js = http_request(f"{url}/tts.json?{urlencode(dict(text=text, **query))}")
            torch.cuda.synchronize()
            served = kernels.launch_counts()
            got = wav_pcm(f"text {text!r} over HTTP", ans, sr)
            lsb = (int(np.abs(got.astype(np.int32) - pcm).max())
                   if len(got) == len(pcm) else None)
            if lsb is None or lsb > 1:
                raise AssertionError(f"text {text!r}: HTTP PCM vs the engine: {lsb} LSB")
            if js[0] != 200 or json.loads(js[2])["phones"] != phones:
                raise AssertionError(f"text {text!r}: /tts.json {js[0]} {js[2][:200]!r}")
            for where, c in (("engine", counts), ("HTTP", served)):
                fired = [c[k] for k in ("rel_attention", "wn_stack", "mrf_stage",
                                        "mrf_stage_folded")]
                idle = {k: v for k, v in c.items() if "_train_" in k and v}
                if 0 in fired or idle:
                    raise AssertionError(f"text {text!r} through the {where}: A-D launches "
                                         f"{fired}, E/F {idle}")
            for k in counts:
                total[k] = total.get(k, 0) + counts[k] + served[k]
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                text_to_phones(text)
                host.append(time.perf_counter() - t0)
            walls, http_walls = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                say(text)
                walls.append(time.perf_counter() - t0)
                http_walls.append(http_request(
                    f"{url}/tts?{urlencode(dict(text=text, **query))}")[3])
            rows.append(dict(text=text, phones=len(phones), samples=len(pcm), http_lsb=lsb,
                             text_to_phones_ms=1e3 * statistics.median(host),
                             engine_ms=1e3 * statistics.median(walls),
                             http_ms=1e3 * statistics.median(http_walls)))
        for text in refused:
            ans = http_request(f"{url}/tts?{urlencode(dict(text=text, **query))}")
            if ans[0] != 400 or b"text frontend" not in ans[2]:
                raise AssertionError(f"text {text!r} without jieba: HTTP {ans[0]} {ans[2]!r}")
            try:
                say(text)
            except ImportError as e:
                error = e
            else:
                raise AssertionError(f"text {text!r} without jieba: the engine did not raise")
            print(f"text {text!r}: HTTP 400 {json.loads(ans[2])['error']!r}; the engine "
                  f"raised {type(error).__name__}: {error}")
        if refused:
            print("text: the Mandarin path was not run on this machine: jieba is not "
                  "importable, and tone sandhi imports it for every hanzi word")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            coalescer.close()
        shutil.rmtree(root, ignore_errors=True)
        frontends._ZH_LEXICON.clear()
        frontends._ZH_LEXICON.update(saved[0])
        frontends._ZH_LEX_MAXLEN = saved[1]
        frontends._EN_LEXICON.clear()
        frontends._EN_LEXICON.update(saved[2])
    print(card_line())
    print("text rows: text_to_phones on the host (median of 20 calls), the request "
          "straight through the engine and over HTTP (medians of 5), ms")
    for r in rows:
        print(f"text {r['text']!r}: {r['phones']} phones, {r['samples']} samples, "
              f"text_to_phones {r['text_to_phones_ms']:.4f} ms, engine {r['engine_ms']:.2f} ms, "
              f"HTTP {r['http_ms']:.2f} ms; HTTP PCM within {r['http_lsb']} LSB, "
              f"synthesize(phones=) 0 LSB")
    print(f"text: launches over the phase {total}")
    return total, rows


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


TRAINER_PACKAGES = ("tensorboardX", "matplotlib", "soundfile")
EVAL_STEPS = (2, 4)       # phase 4c: eval_interval 2 over 4 steps
TRAINER_PROFILE = (2, 3)  # phase 4c: the traced steps [2, 3)
EVAL_PER_CALL = {"rel_attention": 14, "wn_stack": 4, "mrf_stage": 1, "mrf_stage_folded": 1}
BF16_OPTIONS = (   # phase 4d: name, train-config changes
    ("f32", {"fp16_run": False}),
    ("tail_f32", {"fp16_run": True}),
    ("bf16_disc", {"fp16_run": True, "bf16_disc": True}),
    ("bf16_only [dec]", {"fp16_run": True, "bf16_only": ("dec",)}),
    ("stable", {"fp16_run": True, "bf16_scope": "stable", "bf16_allow_divergent": True}),
    ("full", {"fp16_run": True, "bf16_scope": "full", "bf16_allow_divergent": True}),
)


def _cpu_copy(torch, model, like):
    """``like`` (a fresh module of the same kind) on the CPU with ``model``'s
    weights."""
    like.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})
    return like


def _affine_cost(cost_at):
    """{flops, bytes} at batch 12 from the counts at batches 1 and 2: for a
    step's fixed padded shapes the count is a + b·B (the batch's rows, plus
    what is counted once a step)."""
    one, two = cost_at(1), cost_at(2)
    return {k: one[k] + 11 * (two[k] - one[k]) for k in one}


def trainer_phase(torch, cfg, root, record):
    """Phase 4c: the Trainer at full width (batch 12, tail_f32) on phase 4's
    corpus with its validation list: 4 steps through ``Trainer.train`` with
    an eval at steps 2 and 4 and step 2 traced.  Checks the run directory
    (config.json read back, githash, tb/ and tb_eval/), A-D's launches
    (each eval's), the trace file and its E and F kernels, and the eval's
    audio against the plain f32 path on the CPU at noise scale 0 (1e-3 of
    the peak, phase 3b's tolerance).  Times one eval (wall and device) and
    counts its FLOPs on the CPU copy (``utils/flops.model_cost``).  →
    (A-D's launch counts over the train call, the trainer)."""
    import copy
    import importlib.util

    import numpy as np

    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.models.synthesizer import Synthesizer
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.ops.layers import freeze_weight_norm
    from vispeech_tpu_torch.text import N_SYMBOLS
    from vispeech_tpu_torch.train.loop import Trainer, synthesize_utterance
    from vispeech_tpu_torch.utils.flops import chip_peaks, model_cost, roofline_row

    present = {m: importlib.util.find_spec(m) is not None for m in TRAINER_PACKAGES}
    print(f"trainer: importable {present}")
    record["importable"] = present
    cfg, data_root = _corpus(root, cfg)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             eval_interval=EVAL_STEPS[0]))
    trainer = Trainer(cfg, data_root=data_root)
    # random weights predict meaningless durations: bias the duration head
    # as the serving phases' weights do (a phoneme ≈ e^1.8 − 1 frames)
    with torch.no_grad():
        trainer.model_g.duration_predictor.proj.weight.mul_(0.1)
        trainer.model_g.duration_predictor.proj.bias.fill_(1.8)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.train(max_steps=EVAL_STEPS[-1], profile_steps=TRAINER_PROFILE)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"trainer: {EVAL_STEPS[-1]} steps with evals at {EVAL_STEPS} and step "
          f"{TRAINER_PROFILE[0]} traced in {time.perf_counter() - t0:.2f} s; launches {counts}")
    d = cfg.train.save_dir
    if load_config(os.path.join(d, "config.json")) != cfg:
        raise AssertionError("config.json does not read back as the run's config")
    # githash only in a git checkout, as the JAX trainer writes it
    try:
        git = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             cwd=ROOT).returncode
    except OSError:   # no git on the machine
        git = 1
    for name in ("train.log", "tb", "tb_eval", f"ckpt_{EVAL_STEPS[-1]}.pt") + (
            ("githash",) if git == 0 else ()):
        if not os.path.exists(os.path.join(d, name)):
            raise AssertionError(f"the run directory lacks {name}")
    tb_files = sorted(os.listdir(os.path.join(d, "tb")))
    eval_files = sorted(os.listdir(os.path.join(d, "tb_eval")))
    audio = sorted(os.listdir(os.path.join(d, "tb_eval", "audio"))) \
        if "audio" in eval_files else []
    print(f"trainer: run dir {sorted(os.listdir(d))}; tb/ {tb_files}; tb_eval/ {eval_files} "
          f"{audio}")
    if not tb_files or not eval_files:
        raise AssertionError("no TensorBoard output")
    if not present["tensorboardX"] and len(audio) != 2 * len(EVAL_STEPS):
        raise AssertionError(f"the evals' audio was not written: {audio}")
    expect = {k: v * len(EVAL_STEPS) for k, v in EVAL_PER_CALL.items()}
    got = {k: counts[k] for k in EVAL_PER_CALL}
    if got != expect:
        raise AssertionError(f"A-D launches over the evals {got} != {expect}")

    trace_path = os.path.join(d, "profile", f"trace_step_{TRAINER_PROFILE[0]}.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    found = {k: sum(1 for e in events if e.get("cat") == "kernel"
                    and any(p in e.get("name", "") for p in KERNEL_FUNCS[k]))
             for k in KERNEL_FUNCS if "_train_" in k}
    memory = next(iter(trainer.profile_memory.values()), {})
    peak_mib = memory.get("peak_bytes_in_use", 0) / 2 ** 20
    print(f"trainer: trace {trace_path}: {os.path.getsize(trace_path) / 2 ** 20:.2f} MiB, "
          f"{len(events)} events, E/F kernels in it {found}; peak device memory over the "
          f"traced step {peak_mib:.1f} MiB of {memory.get('bytes_limit', 0) / 2 ** 20:.0f}")
    if not all(found.values()):
        raise AssertionError(f"the trace lacks kernels of E or F: {found}")
    record.update(trace_mib=os.path.getsize(trace_path) / 2 ** 20, trace_kernels=found,
                  profiled_peak_mib=peak_mib)

    # one eval: launches, wall and device time
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate(EVAL_STEPS[-1] + 1)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    one = {k: kernels.launch_counts()[k] for k in EVAL_PER_CALL}
    if one != EVAL_PER_CALL:
        raise AssertionError(f"one eval launched {one}, expected {EVAL_PER_CALL}")
    def synth_ms(model):
        t0 = time.perf_counter()
        synthesize_utterance(model, trainer.val_set, 0, seed=6)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the training model's weight norms change every step, so each eval
    # rebuilds B's, C's and D's prepared weights; a frozen copy keeps them
    frozen = freeze_weight_norm(copy.deepcopy(trainer.model_g))
    synth_ms(frozen)
    frozen_ms, live_ms = synth_ms(frozen), synth_ms(trainer.model_g)
    del frozen
    print(f"trainer: eval synthesis {live_ms:.2f} ms on the training model, {frozen_ms:.2f} ms "
          f"on a copy with frozen weight norms and kept kernel weights")
    prof = {}
    profile(torch, "one eval synthesis", lambda: synthesize_utterance(
        trainer.model_g, trainer.val_set, 0, seed=7), 8, prof)

    # the eval's audio against the plain f32 path on the CPU, and its FLOPs
    card = synthesize_utterance(trainer.model_g, trainer.val_set, 0, noise_scale=0.0)
    cpu = _cpu_copy(torch, trainer.model_g, Synthesizer.from_config(cfg, N_SYMBOLS))
    cpu.dec.fused_mrf = False   # the unfolded ResBlock1 path: the model's FLOPs
    held = []
    t0 = time.perf_counter()
    cost = model_cost(lambda: held.append(synthesize_utterance(
        cpu, trainer.val_set, 0, noise_scale=0.0)))
    plain = held[0]
    print(f"trainer: the eval on the CPU (counted) {time.perf_counter() - t0:.2f} s")
    if card["n_frames"] != plain["n_frames"]:
        raise AssertionError(f"eval frames: card {card['n_frames']}, cpu {plain['n_frames']}")
    err = float(np.abs(card["audio"] - plain["audio"]).max())
    peak = float(np.abs(plain["audio"]).max())
    ok = err <= 1e-3 * max(peak, 1e-3)
    print(f"trainer: eval audio on the card vs the plain f32 path on the CPU: "
          f"{card['n_frames']} frames, {len(card['audio'])} samples, max_abs_err {err:.3e}, "
          f"peak {peak:.3e} (tol 1e-3 of peak) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the eval's audio disagrees with the plain path: {err}")
    row = roofline_row(cost["flops"], cost["bytes"], live_ms, "f32", chip_peaks())
    print(f"trainer: one eval {eval_ms:.2f} ms wall (logging included), its synthesis "
          f"{live_ms:.2f} ms wall, {prof.get('busy_ms', 0):.2f} ms device busy under the "
          f"profiler; launches {one}; {cost['flops'] / 1e9:.2f} GFLOP, "
          f"{cost['bytes'] / 1e9:.3f} GB (model_cost); roofline of the synthesis (f32 peak) "
          f"{row}; {card_line()}")
    record.update(eval_ms=eval_ms, synth_ms=live_ms, synth_frozen_ms=frozen_ms,
                  eval_busy_ms=prof.get("busy_ms"),
                  eval_launches=one,
                  eval_frames=card["n_frames"], eval_max_abs_err=err, eval_cost=cost,
                  eval_roofline=row)
    return {k: counts[k] for k in EVAL_PER_CALL}, trainer


def bf16_phase(torch, cfg, trainer, record):
    """Phase 4d: one batch of 12 of phase 4c's corpus through a TrainStep
    for each of ``BF16_OPTIONS`` on 4c's weights, in two passes (the second
    in the reverse order): a warm-up step, then 3 timed steps a pass (the
    median of 6), E and F launching 5 + 5 and 14 + 14 times a step, finite
    losses; a tail_f32 and a bf16_disc step profiled, for the scale
    discriminator's grouped-conv input gradient in f32 and bf16.  The tail_f32 step's FLOPs
    are counted on the CPU copy (batches 1 and 2, extrapolated to 12) for
    its MFU against the bf16 peak."""
    import numpy as np

    from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from vispeech_tpu_torch.models.synthesizer import Synthesizer
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.text import N_SYMBOLS
    from vispeech_tpu_torch.train.step import TrainStep
    from vispeech_tpu_torch.utils.flops import chip_peaks, model_cost, roofline_row

    batches = (b for _, b in trainer.batches())
    batch = next(batches)
    batches.close()
    frames = batch["wav"].shape[1] // cfg.data.hop_length
    print(f"bf16 options: batch {tuple(batch['wav'].shape[:2])} ({frames} frames, "
          f"{batch['phonemes'].shape[1]} phonemes)")
    per_step = {"wn_stack_train_fwd": 5, "wn_stack_train_bwd": 5,
                "rel_attention_train_fwd": 14, "rel_attention_train_bwd": 14}
    rows = {name: {"step_ms": []} for name, _ in BF16_OPTIONS}
    # two passes, the second in the reverse order, 3 timed steps an option each
    for order in (BF16_OPTIONS, BF16_OPTIONS[::-1]):
        for name, change in order:
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **change))
            step = TrainStep(c, trainer.model_g, trainer.model_d, trainer.steps_per_epoch)
            step(batch)
            torch.cuda.synchronize()
            kernels.reset_launches()
            times, metrics = [], None
            for _ in range(3):
                t0 = time.perf_counter()
                metrics = step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            counts = kernels.launch_counts()
            bad = [k for k, v in metrics.items() if not np.isfinite(float(v))]
            want = {k: 3 * v for k, v in per_step.items()}
            stages = trainer.model_g.bf16_stages or (
                "(whole graph)" if c.train.fp16_run else "none")
            print(f"  {name}: bf16 stages {stages}, discriminators {str(step.d_dtype)[6:]}: "
                  f"steps {[round(t, 2) for t in times]} ms; g="
                  f"{float(metrics['loss/g/total']):.3f} d={float(metrics['loss/d/total']):.3f}"
                  f"; E/F launches { {k: counts[k] for k in per_step} }")
            if bad:
                raise AssertionError(f"{name}: non-finite metrics {bad}")
            if {k: counts[k] for k in per_step} != want:
                raise AssertionError(f"{name}: E/F launches {counts} != {want}")
            rows[name]["step_ms"] += times
            if name in ("tail_f32", "bf16_disc") and order is BF16_OPTIONS:
                rows[name]["profile"] = {}
                profile(torch, f"{name} step ({frames} frames)", lambda: step(batch), 12,
                        rows[name]["profile"], {"grouped dgrad": "dgrad2d_grouped"})
            del step
    for name, row in rows.items():
        row["median_ms"] = float(np.median(row["step_ms"]))
    grouped = {k: rows[k]["profile"].get("matched", {}).get("grouped dgrad", "not measured")
               for k in ("tail_f32", "bf16_disc")}
    print("bf16 options: median of 6 steps, ms: " + ", ".join(
        f"{k} {r['median_ms']:.2f}" for k, r in rows.items())
        + f"; the scale discriminator's grouped-conv input gradient (ms, launches): f32 "
        f"{grouped['tail_f32']}, bf16 {grouped['bf16_disc']}; {card_line()}")
    trainer.model_g.bf16_stages = cfg.train.effective_bf16_stages()

    # FLOPs of a tail_f32 step, counted on CPU copies at batches 1 and 2
    def cost_at(b):
        g = _cpu_copy(torch, trainer.model_g, Synthesizer.from_config(cfg, N_SYMBOLS))
        d = _cpu_copy(torch, trainer.model_d, MultiPeriodDiscriminator())
        step = TrainStep(cfg, g, d, trainer.steps_per_epoch, tf32=False)
        sub = {k: None if v is None else v[:b].cpu() for k, v in batch.items()}
        return model_cost(step, sub)

    t0 = time.perf_counter()
    cost = _affine_cost(cost_at)
    ms = rows["tail_f32"]["median_ms"]
    row = roofline_row(cost["flops"], cost["bytes"], ms, "bf16", chip_peaks())
    print(f"bf16 options: a tail_f32 step of batch 12 at {frames} frames: "
          f"{cost['flops'] / 1e9:.2f} GFLOP, {cost['bytes'] / 1e9:.3f} GB (model_cost on the "
          f"CPU at batches 1 and 2, {time.perf_counter() - t0:.2f} s); roofline (bf16 peak) "
          f"{row}; {card_line()}")
    record.update(options=rows, step_frames=frames, step_cost=cost, step_roofline=row)


DDP_STEPS = 3   # phase 4e: steps of the 1-rank and the one-process Trainer
DDP_TIMED = 5   # phase 4e: turns of (plain, mesh, mesh, plain) timed steps
CLI_TIMEOUT = 300


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_phase(torch, cfg, root, record, device=None):
    """Phase 4e (also alone as ``--ddp``): the data axis on the card.  In
    this process: a 1-rank NCCL group (127.0.0.1, a free port) and a
    full-width ``Trainer`` on it (batch 12, phase 4's corpus), ``DDP_STEPS``
    steps through ``Trainer.train``, then a one-process ``Trainer`` from the
    same seed on the same batches, with cuDNN deterministic: their largest
    parameter difference must be 0 (else it must not exceed that of a
    second one-process run).  E's and F's launches a step, one profiled
    step's NCCL and ``cat`` kernels (count and device time: a world of one
    runs no gradient all-reduce), the flattened all-reduce that a larger
    world runs (``parallel/mesh.py::all_reduce_mean_`` of G's and of D's
    gradients on the 1-rank group: time and bound), and the step's wall
    time in turns with the one-process Trainer's.  Through the CLI: ``torchrun
    --standalone --nproc_per_node 1 -m vispeech_tpu_torch.train.cli`` to
    step 2, then to step 4: exit 0, ``ckpt_*.pt`` and the TensorBoard
    output written, the second run resumed at step 2, and the checkpoint
    served by ``TTSEngine.from_checkpoint``.  ``device`` None means the
    card.  → E's and F's launch counts over the in-process mesh run."""
    import numpy as np

    from vispeech_tpu_torch.config import save_config
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.parallel import make_mesh
    from vispeech_tpu_torch.parallel.mesh import all_reduce_mean_
    from vispeech_tpu_torch.train.loop import Trainer

    cfg, data_root = _corpus(root, cfg)
    per_step = {"wn_stack_train_fwd": 5, "wn_stack_train_bwd": 5,
                "rel_attention_train_fwd": 14, "rel_attention_train_bwd": 14}

    def run_dir(name):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=os.path.join(root, name)))

    launcher = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in launcher}
    os.environ.update(launcher)
    try:
        mesh = make_mesh(device=device, init_method=f"tcp://127.0.0.1:{_free_port()}")
        try:
            print(f"ddp: rank {mesh.rank} of {mesh.world_size} on {mesh.device}, backend "
                  f"{torch.distributed.get_backend()}")
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True   # for the comparison alone
            try:
                dist_trainer = Trainer(run_dir("mesh"), data_root=data_root, mesh=mesh)
                kernels.reset_launches()
                dist_trainer.train(max_steps=DDP_STEPS)
                torch.cuda.synchronize()
                counts = {k: kernels.launch_counts()[k] for k in per_step}

                def trained(name):
                    t = Trainer(run_dir(name), data_root=data_root, device=device)
                    t.train(max_steps=DDP_STEPS)
                    return t

                def max_diff(a, b):
                    return max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(
                        [*a.model_g.parameters(), *a.model_d.parameters()],
                        [*b.model_g.parameters(), *b.model_d.parameters()]))

                plain = trained("plain")
                diff = max_diff(dist_trainer, plain)
                limit = 0.0
                if diff > 0.0:   # cuDNN left something nondeterministic: measure it
                    limit = max_diff(plain, trained("plain2"))
            finally:
                torch.backends.cudnn.deterministic = deterministic
            want = {k: DDP_STEPS * v for k, v in per_step.items()}
            print(f"ddp: E/F launches over {DDP_STEPS} steps on the mesh {counts} "
                  f"({ {k: v / DDP_STEPS for k, v in counts.items()} } a step), expected {want}")
            if counts != want:
                raise AssertionError(f"E/F launches on the mesh {counts} != {want}")
            ok = diff <= limit
            print(f"ddp: after {DDP_STEPS} steps (cuDNN deterministic) the 1-rank NCCL Trainer "
                  f"vs the one-process Trainer: largest parameter difference {diff:.3e} (limit "
                  f"{limit:.3e}{', two one-process runs' if diff > 0.0 else ''}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the 1-rank run differs from one process by {diff:.3e}")

            batches = (b for _, b in dist_trainer.batches())
            batch = next(batches)
            batches.close()
            prof = {}
            profile(torch, "1-rank NCCL train step", lambda: dist_trainer.step_fn(batch), 8,
                    prof, {"nccl": "nccl", "cat": "CatArrayBatchedCopy"})
            matched = prof.get("matched", {})
            print(f"ddp: in one profiled step (ms, count): NCCL kernels "
                  f"{matched.get('nccl', 'not measured')}, the flattening cat kernels "
                  f"{matched.get('cat', 'not measured')}; busy "
                  f"{prof.get('busy_ms', float('nan')):.2f} ms of {prof.get('wall_ms', 0):.2f}")
            # the gradient all-reduce alone (flatten, all-reduce, divide) on this
            # step's gradients, as a world of more than one runs it (a world of
            # one skips it), and its bound: each gradient read, the buffer
            # written, read and written again
            reduce_ms = {}
            for name, model in (("G", dist_trainer.model_g), ("D", dist_trainer.model_d)):
                params = [p for p in model.parameters() if p.grad is not None]
                n = sum(p.numel() for p in params)
                ms = time_ms(lambda: all_reduce_mean_(params, mesh.data_group, 1), 10)
                b_ms, _ = bound(4 * 4 * n, 0, "float32")
                reduce_ms[name] = {"ms": ms, "bound_ms": b_ms, "params": n}
                print(f"ddp: all_reduce_mean_ of {name}'s {n / 1e6:.2f} M gradients "
                      f"({4 * n / 2 ** 20:.1f} MiB) on the 1-rank group, as a larger world "
                      f"runs it (skipped at world size 1): {ms:.4f} ms a call (CUDA events "
                      f"over 10 calls: the host's dispatch where it is the slower), bound "
                      f"{b_ms:.4f} ms (bytes)")
            times = {"plain": [], "mesh": []}
            for name in ("plain", "mesh", "mesh", "plain") * DDP_TIMED:
                step = (dist_trainer if name == "mesh" else plain).step_fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            print(f"ddp: step wall ms in turns, one process {[round(t, 2) for t in times['plain']]}"
                  f", 1-rank mesh {[round(t, 2) for t in times['mesh']]}; medians "
                  f"{np.median(times['plain']):.2f} / {np.median(times['mesh']):.2f}; "
                  f"{card_line()}")
            record.update(param_diff=diff, param_limit=limit, launches=counts, profiled=prof,
                          average_grads=reduce_ms, step_ms=times)
            del dist_trainer, plain
        finally:
            mesh.close()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()

    # the CLI under torchrun, one process on the card: 2 steps, then resumed to 4
    cli_cfg = run_dir("cli")
    cfg_path = os.path.join(root, "cli_config.json")
    save_config(cli_cfg, cfg_path)
    env = {k: v for k, v in os.environ.items() if k not in launcher}
    env["PYTHONPATH"] = ROOT
    logs = []
    for target in (2, 4):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", "-m", "vispeech_tpu_torch.train.cli", "-c", cfg_path, "--data-root",
             data_root, "--max-steps", str(target)] + (["--device", device] if device else []),
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        print(f"ddp: torchrun --nproc_per_node 1 ... --max-steps {target}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            raise AssertionError(f"the CLI under torchrun exited {proc.returncode}")
        logs.append(proc.stderr)
    run = cli_cfg.train.save_dir
    listing = sorted(os.listdir(run))
    tb = sorted(os.listdir(os.path.join(run, "tb")))
    print(f"ddp: CLI run dir {listing}; tb/ {tb}")
    if "ckpt_4.pt" not in listing or not tb:
        raise AssertionError(f"the CLI's run dir lacks ckpt_4.pt or TensorBoard output")
    if "resumed at step 2" not in logs[1]:
        raise AssertionError("the second CLI run did not resume at step 2")
    engine = TTSEngine.from_checkpoint(os.path.join(run, "config.json"), run,
                                       device=device or "cuda")
    print(f"ddp: the second run resumed at step 2; ckpt_4.pt served by "
          f"TTSEngine.from_checkpoint on {engine.device}")
    del engine
    torch.cuda.empty_cache()
    return counts


TP_STEPS = 3        # phase 4g: steps of the model-axis world and of one process
TP_TIMEOUT = 900    # phase 4g: seconds the two ranks may take
# phase 4g: step 1 (before any update) against one process: losses and grad
# norms relative at the CPU test's bound (tests/test_torch_tp.py) in f32
# (TF32 off) and at bf16's in tail_f32, whose column-parallel decoder rounds
# its products apart.  In f32 also each gradient, relative to max(its peak,
# 1e-3 × the largest peak), within the bound or TP_CONTROL × the largest
# such deviation of a control, whichever is larger: the control is one
# process whose weights start one ulp apart (the decoder's bias and gain
# gradients sum ~10^5 terms that cancel, so one ulp moves them by ~2e-3 of
# their peak at full width, and another summation order by ~1e-4).  Steps
# 2-3, where the GAN carries any rounding far: f32 within TP_CONTROL × the
# control's deviation or the bound; tail_f32 at the bound
TP_RTOL = {"f32": 1e-5, "tail_f32": 2e-2}
TP_CONTROL = 10
# phase 4g, f32: the parameters after 3 steps that lie beyond 1e-6 of one
# process's (the attention key biases' aside: their gradient is rounding
# noise) at most this many times the control's count
TP_OFF_CONTROL = 2
NVLINK_BYTES = 450e9   # H100 SXM NVLink 4: 900 GB/s both ways, 450 GB/s a direction
TRAIN_PER_STEP = {"wn_stack_train_fwd": 5, "wn_stack_train_bwd": 5,
                  "rel_attention_train_fwd": 14, "rel_attention_train_bwd": 14}


def _tp_run_cfg(cfg, precision, root, name):
    """Phase 4g's run: ``precision`` "f32" (fp16_run off) or "tail_f32" (the
    config's bf16 body), saved under ``root/name_precision``."""
    train = dataclasses.replace(cfg.train, save_dir=os.path.join(root, f"{name}_{precision}"),
                                fp16_run=precision != "f32")
    return dataclasses.replace(cfg, train=train)


def _recorded(torch, trainer, precision, on_card):
    """Record each step's metrics and wall ms (host clock, synchronized) of
    ``trainer``, and step 1's gradients, whole (gathered over the model
    group: a collective), on the host, under ``"grads"``; TF32 off in f32
    (the comparison's), as the trainer's own in tail_f32."""
    step = trainer.step_fn
    step.tf32 = on_card and precision != "f32"
    rec = {"metrics": [], "wall_ms": []}
    inner = step._step

    def whole(name, t):
        return t if trainer.plan is None else trainer.plan.whole(name, t)

    def recorded(*args):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = inner(*args)
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        if len(rec["metrics"]) == 1:
            rec["grads"] = {
                **{f"model_g.{k}": whole(k, p.grad).cpu()
                   for k, p in trainer.model_g.named_parameters() if p.grad is not None},
                **{f"model_d.{k}": p.grad.cpu()
                   for k, p in trainer.model_d.named_parameters() if p.grad is not None}}
        return m

    step._step = recorded
    return rec


def _counted_collectives(torch, fn, batch_size):
    """``fn()`` with every ``all_gather`` and ``all_reduce`` counted: {kind:
    [calls, bytes each rank sends]}, kinds "activation gather" (a tensor of
    the batch's leading dim), "weight gather", "input-grad all-reduce" (the
    batch's), "gradient all-reduce" (the replicated and partial gradients,
    flattened) and "other all-reduce" (norms, the grad norm).  A rank of 2
    sends its slice in a gather and half the tensor twice in a ring
    all-reduce."""
    import torch.distributed as dist

    counts = {}
    gather, reduce = dist.all_gather, dist.all_reduce

    def add(kind, nbytes):
        c = counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes

    def counted_gather(parts, t, *a, **k):
        add("activation gather" if t.dim() == 3 and t.shape[0] == batch_size else
            "weight gather", (len(parts) - 1) * t.numel() * t.element_size())
        return gather(parts, t, *a, **k)

    def counted_reduce(t, *a, **k):
        add("input-grad all-reduce" if t.dim() == 3 and t.shape[0] == batch_size else
            "gradient all-reduce" if t.dim() == 1 and t.numel() >= 2 ** 20 else
            "other all-reduce", t.numel() * t.element_size())
        return reduce(t, *a, **k)

    dist.all_gather, dist.all_reduce = counted_gather, counted_reduce
    try:
        fn()
    finally:
        dist.all_gather, dist.all_reduce = gather, reduce
    return counts


def _deviation(a, b):
    """Run ``a`` against run ``b`` ({"steps": {"metrics": [...], "grads":
    step 1's}, "params": {name: tensor}}) → {"step1": the largest relative
    difference of step 1's losses and grad norms and its key, "ratios":
    step 1's gradient differences, each over max(its peak in ``b``, 1e-3 ×
    the largest peak), by parameter, "grads": the largest and its key,
    "later": the losses' and
    grad norms' of the later steps, "diff": the largest parameter
    difference after the last step, "off" and "total": the elements beyond
    1e-6 and the elements, both but the attention key biases', whose
    gradient is rounding noise}."""
    def worst_metric(xs, ys):
        out = (0.0, None)
        for x, y in zip(xs, ys):
            for k in y:
                rel = abs(x[k] - y[k]) / max(abs(y[k]), 1e-12)
                if rel > out[0] or out[1] is None:
                    out = (rel, k)
        return out

    ma, mb = a["steps"]["metrics"], b["steps"]["metrics"]
    ga, gb = a["steps"]["grads"], b["steps"]["grads"]
    if ga.keys() != gb.keys():
        raise AssertionError("the runs' step-1 gradients are of different parameters")
    biggest = max(float(g.abs().max()) for g in gb.values())
    ratios = {k: float((ga[k].float() - g.float()).abs().max())
              / max(float(g.abs().max()), 1e-3 * biggest) for k, g in gb.items()}
    grads = max((r, k) for k, r in ratios.items())
    diff, off, total = 0.0, 0, 0
    for name, w in b["params"].items():
        d = (a["params"][name].float() - w.float()).abs()
        diff = max(diff, float(d.max()))
        if ".conv_k.bias" not in name:
            off, total = off + int((d > 1e-6).sum()), total + w.numel()
    return {"step1": worst_metric(ma[:1], mb[:1]), "ratios": ratios, "grads": grads,
            "later": worst_metric(ma[1:], mb[1:]), "diff": diff, "off": off, "total": total}


def _tp_rank(rank, port, cfg, data_root, root, device):
    """One rank of phase 4g's (data 1 × model 2) world: both on ``cuda:0``
    (``device`` "cpu" for a rehearsal) over gloo.  → ``root/rank{rank}.json``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.parallel import make_mesh
    from vispeech_tpu_torch.train.loop import Trainer

    on_card = device != "cpu"
    mesh = make_mesh(model=2, device=device, backend="gloo",
                     init_method=f"tcp://127.0.0.1:{port}")
    rec = {"rank": rank, "device": str(mesh.device), "backend": "gloo"}
    try:
        rec["probe"] = _gloo_probe(torch, mesh) if on_card else {}
        for precision in ("f32", "tail_f32"):
            trainer = Trainer(_tp_run_cfg(cfg, precision, root, "tp"), data_root=data_root,
                              mesh=mesh)
            steps = _recorded(torch, trainer, precision, on_card)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            # ckpt_3.pt: whole tensors, after Mesh.check_replicas
            trainer.train(max_steps=TP_STEPS)
            grads = steps.pop("grads")
            if rank == 0:
                torch.save(grads, os.path.join(root, f"tp_grads_{precision}.pt"))
            del grads
            r = {"launches": kernels.launch_counts(),
                 "steps": {k: list(v) for k, v in steps.items()},
                 "replicated": len(list(trainer.model_d.parameters())) + sum(
                     k not in trainer.plan.dims for k, _ in trainer.model_g.named_parameters())}
            if on_card:
                r["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
            if precision == "tail_f32":
                kernels.reset_launches()
                out = trainer.evaluate(TP_STEPS)   # the model group's eval, A-D
                r["eval_launches"] = kernels.launch_counts()
                if rank == 0:
                    np.save(os.path.join(root, "tp_eval.npy"), out["audio"])
                batches = (b for _, b in trainer.batches())
                batch = next(batches)
                batches.close()

                r["collectives"] = _counted_collectives(
                    torch, lambda: trainer.step_fn(batch), batch["wav"].shape[0])
                if on_card:
                    prof = {}
                    if rank == 0:
                        profile(torch, "rank 0's model-axis step (tail_f32)",
                                lambda: trainer.step_fn(batch), 6, prof,
                                {"gloo copies": "Memcpy"})
                    else:
                        trainer.step_fn(batch)
                    r["profile"] = prof
            rec[precision] = r
            for writer in (trainer.tb, trainer.tb_eval):   # rank 0's
                if writer is not None:
                    writer.close()
            del trainer
            if on_card:
                torch.cuda.empty_cache()
    finally:
        mesh.close()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)


def _gloo_probe(torch, mesh):
    """Which gloo collectives take CUDA tensors on this torch: each on the
    model group, held to its result.  → {collective: "ok", "wrong result"
    or the error}."""
    import torch.distributed as dist

    group, r = mesh.model_group, mesh.model_rank
    x = torch.full((4,), float(r + 1), device=mesh.device)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return bool(y.eq(3).all())

    def all_gather(dtype=torch.float32):
        parts = [torch.empty_like(x, dtype=dtype) for _ in range(2)]
        dist.all_gather(parts, x.to(dtype), group=group)
        return bool(parts[0].eq(1).all() and parts[1].eq(2).all())

    def all_gather_into_tensor():
        out = torch.empty(8, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return bool(out[:4].eq(1).all() and out[4:].eq(2).all())

    def reduce_scatter_tensor():
        out = torch.empty(2, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return bool(out.eq(3).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0, group=group)
        return bool(y.eq(1).all())

    out = {}
    for name, call in (("all_reduce", all_reduce), ("all_gather (list)", all_gather),
                       ("all_gather bf16", lambda: all_gather(torch.bfloat16)),
                       ("all_gather_into_tensor", all_gather_into_tensor),
                       ("reduce_scatter_tensor", reduce_scatter_tensor),
                       ("broadcast", broadcast)):
        try:
            out[name] = "ok" if call() else "wrong result"
        except Exception as e:   # a collective that gloo lacks for CUDA tensors
            out[name] = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:120]}"
    return out


def tp_phase(torch, cfg, root, record, device=None):
    """Phase 4g (also alone as ``--tp``): the model axis on one card.  NCCL
    refuses two ranks on one device, so a (data 1 × model 2) world of two
    processes on ``cuda:0`` runs over gloo, which stages CUDA tensors
    through the host (the phase passes that backend; the CLI on CUDA stays
    NCCL): which gloo collectives take CUDA tensors; ``TP_STEPS`` steps of
    a full-width ``Trainer`` on phase 4's corpus, in f32 (TF32 off) and in
    tail_f32, against one process's on the same batches (cuDNN
    deterministic there; the ranks keep the trainer's own settings, and
    their metrics must be bit-equal and their replicated parameters pass
    ``Mesh.check_replicas`` at the checkpoint): step 1's losses and grad
    norms (``TP_RTOL``) and in f32 every gradient gathered, at ``TP_RTOL``
    or against a control, one process whose weights start one ulp apart
    (``TP_CONTROL``); the later steps' losses and grad norms, in
    f32 also the parameters after gathering (elements beyond 1e-6),
    against the control (``TP_CONTROL``, ``TP_OFF_CONTROL``); E's and F's
    launches a step on each rank; the model group's eval (A-D on each rank)
    against one process's on the gathered weights (1e-4 of the peak); the
    bytes the model axis moves in a step, counted at its collectives, and
    their bound over NVLink; rank 0's profiled step; step wall times; then
    ``torchrun --nproc_per_node 1 ... --model-parallel 1`` through the CLI.
    ``device`` "cpu" rehearses it on the host (no launches, no profile).
    → rank 0's launches: E and F over the tail_f32 steps, A-D in its eval."""
    import numpy as np

    import torch.multiprocessing as mp

    from vispeech_tpu_torch.data.dataset import FilelistDataset
    from vispeech_tpu_torch.models.synthesizer import Synthesizer
    from vispeech_tpu_torch.text import N_SYMBOLS
    from vispeech_tpu_torch.train.loop import Trainer, synthesize_utterance

    on_card = device != "cpu"
    device = device or "cuda"
    cfg, data_root = _corpus(root, cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    one = {}
    try:
        # one process in each precision, and in f32 a control whose weights
        # start one unit in the last place apart: how far rounding carries
        for name, precision, ulp in (("f32", "f32", False), ("ulp", "f32", True),
                                     ("tail_f32", "tail_f32", False)):
            t = Trainer(_tp_run_cfg(cfg, precision, root, name), data_root=data_root,
                        device=device)
            if ulp:
                with torch.no_grad():
                    for p in [*t.model_g.parameters(), *t.model_d.parameters()]:
                        p.mul_(1 + 2 ** -23)
            steps = _recorded(torch, t, precision, on_card)
            t.train(max_steps=TP_STEPS)
            one[name] = {"steps": steps, "params": {
                f"{net}.{k}": v.detach().cpu() for net in ("model_g", "model_d")
                for k, v in getattr(t, net).state_dict().items()}}
            del t
            if on_card:
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    ctx = mp.get_context("spawn")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, cfg, data_root, root, device))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(t0 + TP_TIMEOUT - time.perf_counter(), 1.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    print(f"tp: two ranks on {device} over gloo, (data 1 x model 2), the trainer's own cuDNN "
          f"settings (deterministic {torch.backends.cudnn.deterministic}, benchmark "
          f"{torch.backends.cudnn.benchmark}): exit codes {codes} in "
          f"{time.perf_counter() - t0:.1f} s")
    if codes != [0, 0]:
        raise AssertionError(f"phase 4g's ranks exited {codes} (None: hung)")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if on_card:
        print(f"tp: gloo collectives on CUDA tensors: {ranks[0]['probe']}")
        for name in ("all_reduce", "all_gather (list)", "all_gather bf16"):
            if ranks[0]["probe"][name] != "ok":
                raise AssertionError(f"gloo's {name} on CUDA tensors: {ranks[0]['probe'][name]}")

    control = _deviation(one["ulp"], one["f32"])
    print(f"tp: f32 control, one process whose weights start one unit in the last place "
          f"apart, against one process: step 1's losses and grad norms within "
          f"{control['step1'][0]:.3e} relative ({control['step1'][1]}), its gradients "
          f"{control['grads'][0]:.3e} ({control['grads'][1]}); steps 2-{TP_STEPS} "
          f"{control['later'][0]:.3e} ({control['later'][1]}); parameters "
          f"{control['diff']:.3e}, {control['off']} of {control['total']} elements beyond 1e-6")
    for precision in ("f32", "tail_f32"):
        for rank in ranks:
            got = rank[precision]["steps"]["metrics"]
            if len(got) != TP_STEPS or got != ranks[0][precision]["steps"]["metrics"]:
                raise AssertionError(f"{precision}: the ranks' metrics differ or miss steps")
        print(f"tp: {precision}: both ranks' metrics bit-equal over {TP_STEPS} steps; "
              f"Mesh.check_replicas passed at ckpt_{TP_STEPS}.pt: "
              f"{ranks[0][precision]['replicated']} replicated tensors bit-equal on both ranks")
        state = torch.load(os.path.join(root, f"tp_{precision}", f"ckpt_{TP_STEPS}.pt"),
                           map_location="cpu", weights_only=False)
        world = {"steps": {**ranks[0][precision]["steps"], "grads": torch.load(
                     os.path.join(root, f"tp_grads_{precision}.pt"), weights_only=False)},
                 "params": {f"{net}.{k}": v for net in ("model_g", "model_d")
                            for k, v in state[net].items()}}
        dev = _deviation(world, one[precision])
        del world, state
        rtol = TP_RTOL[precision]
        ratios = dev.pop("ratios")
        later, max_off, grads_ok, grads_note = rtol, None, True, "no bound"
        if precision == "f32":
            later = max(rtol, TP_CONTROL * control["later"][0])
            max_off = TP_OFF_CONTROL * control["off"]
            bound = max(rtol, TP_CONTROL * control["grads"][0])
            # how far each tensor lies from the control's deviation on it
            over = max((r / max(rtol, control["ratios"][k]), k) for k, r in ratios.items())
            beyond = sum(r > rtol for r in ratios.values())
            grads_ok = dev["grads"][0] <= bound
            grads_note = (f"bound {bound:.3g}; {beyond} of {len(ratios)} tensors beyond "
                          f"{rtol:.0e}; the largest over max({rtol:.0e}, the control's on the "
                          f"same tensor) {over[0]:.3f} ({over[1]})")
        checks = {"step 1's losses and grad norms": dev["step1"][0] <= rtol,
                  "step 1's gradients": grads_ok,
                  "the later losses and grad norms": dev["later"][0] <= later,
                  "the parameters": max_off is None or dev["off"] <= max_off}
        ok = all(checks.values())
        print(f"tp: {precision}, {TP_STEPS} steps, the model-axis world against one process: "
              f"step 1's losses and grad norms within {dev['step1'][0]:.3e} relative "
              f"({dev['step1'][1]}; bound {rtol:.3g}), its gradients, gathered, "
              f"{dev['grads'][0]:.3e} of max(peak, 1e-3 x the largest) ({dev['grads'][1]}; "
              f"{grads_note}); "
              f"steps 2-{TP_STEPS} {dev['later'][0]:.3e} ({dev['later'][1]}; bound {later:.3g}); "
              f"parameters, gathered: largest difference {dev['diff']:.3e}, {dev['off']} of "
              f"{dev['total']} elements beyond 1e-6"
              + (f" (bound {max_off})" if max_off is not None else " (no bound)")
              + f" {'ok' if ok else 'FAIL: ' + str([k for k, v in checks.items() if not v])}")
        print(f"tp: {precision} step wall ms (host clock, synchronized): one process "
              f"{[round(x, 2) for x in one[precision]['steps']['wall_ms']]}, rank 0 "
              f"{[round(x, 2) for x in ranks[0][precision]['steps']['wall_ms']]}, rank 1 "
              f"{[round(x, 2) for x in ranks[1][precision]['steps']['wall_ms']]}"
              + (f"; peak memory a rank {[round(r[precision]['peak_mib']) for r in ranks]} "
                 f"MiB" if on_card else ""))
        record[precision] = {**{k: dev[k] for k in ("step1", "grads", "later", "diff", "off",
                                                   "total")},
                             "one_ms": one[precision]["steps"]["wall_ms"],
                             "rank_ms": [r[precision]["steps"]["wall_ms"] for r in ranks]}
        if not ok:
            raise AssertionError(f"phase 4g: the {precision} model axis is off one process")
    control.pop("ratios")
    record["f32_control"] = control

    want = {k: TP_STEPS * v for k, v in TRAIN_PER_STEP.items()}
    tail = [r["tail_f32"] for r in ranks]
    if on_card:
        for r, t in enumerate(tail):
            got = {k: t["launches"][k] for k in want}
            print(f"tp: rank {r}'s E/F launches over {TP_STEPS} tail_f32 steps {got}, "
                  f"expected {want}; its eval's A-D "
                  f"{ {k: t['eval_launches'][k] for k in EVAL_PER_CALL} }")
            if got != want or any(t["eval_launches"][k] != v for k, v in EVAL_PER_CALL.items()):
                raise AssertionError(f"phase 4g: rank {r}'s launches are off")

    # the model group's eval against one process's on the gathered weights
    state = torch.load(os.path.join(root, "tp_tail_f32", f"ckpt_{TP_STEPS}.pt"),
                       map_location="cpu", weights_only=False)
    model = Synthesizer.from_config(cfg, N_SYMBOLS)
    model.load_state_dict(state["model_g"])
    model.to(device)
    val = FilelistDataset(cfg.data.validation_files, cfg.data, data_root)
    want_audio = synthesize_utterance(model, val, 0, 1024, seed=TP_STEPS)["audio"]
    got_audio = np.load(os.path.join(root, "tp_eval.npy"))
    err = float(np.abs(got_audio - want_audio).max()) if got_audio.shape == want_audio.shape \
        else float("inf")
    peak = float(np.abs(want_audio).max())
    print(f"tp: the model group's eval ({got_audio.shape[0]} samples) against one process's "
          f"on the gathered weights: largest difference {err:.3e} ({err / peak:.3e} of the "
          f"peak, bound 1e-4) {'ok' if err <= 1e-4 * peak else 'FAIL'}")
    if not err <= 1e-4 * peak:
        raise AssertionError("phase 4g: the model group's eval is off one process's")
    del model
    if on_card:
        torch.cuda.empty_cache()

    coll = tail[0]["collectives"]
    total_bytes = sum(b for _, b in coll.values())
    print(f"tp: the model axis in one tail_f32 step at batch {cfg.train.batch_size} (rank 0, "
          f"counted at its collectives; bytes a rank sends): " + ", ".join(
              f"{k} {n} calls {b / 2 ** 20:.1f} MiB" for k, (n, b) in sorted(coll.items()))
          + f"; total {total_bytes / 2 ** 20:.1f} MiB, over NVLink (450 GB/s a direction, not "
          f"measured) at least {1e3 * total_bytes / NVLINK_BYTES:.3f} ms")
    prof = tail[0].get("profile") or {}
    if prof:
        print(f"tp: rank 0's profiled tail_f32 step: wall {prof['wall_ms']:.2f} ms, device "
              f"busy {prof['busy_ms']:.2f} ms, device copies (gloo's staging among them) "
              f"{prof['matched'].get('gloo copies')}; {card_line()}")
    record.update(probe=ranks[0]["probe"], collectives=coll, nvlink_bound_ms=1e3 * total_bytes
                  / NVLINK_BYTES, profile=prof, eval_err=err)

    # the CLI under torchrun at --model-parallel 1, one process
    from vispeech_tpu_torch.config import save_config

    cli_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_dir=os.path.join(root, "cli")))
    cfg_path = os.path.join(root, "cli_config.json")
    save_config(cli_cfg, cfg_path)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "vispeech_tpu_torch.train.cli", "-c", cfg_path, "--data-root", data_root,
         "--max-steps", "1", "--model-parallel", "1"] + ([] if on_card else ["--device", "cpu"]),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    print(f"tp: torchrun --nproc_per_node 1 ... --model-parallel 1 --max-steps 1: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0 or "ckpt_1.pt" not in os.listdir(cli_cfg.train.save_dir):
        print(proc.stderr[-4000:])
        raise AssertionError("the CLI at --model-parallel 1 failed")
    counts = {k: tail[0]["launches"][k] for k in TRAIN_PER_STEP}
    counts.update({k: tail[0]["eval_launches"][k] for k in EVAL_PER_CALL})
    return counts


CP_TIMEOUT = 600        # phase 4h: seconds its two ranks may take
CP_PROBE_TIMEOUT = 60   # phase 4h: seconds a pair of probe processes may take
CP_PROBE_OPS = ("send/recv", "isend/irecv", "batch_isend_irecv")
# phase 4h's ring: the FramePriorNet's attention (hidden 192 in 2 heads of
# 96, window 4) at the 1400-frame bucket, items of 1400 and 1100 frames
CP_RING = {"B": 2, "H": 2, "T": 1400, "d": 96, "w": 4, "lengths": (1400, 1100)}
CP_RING_TOL = 1e-5      # f32, TF32 off: kernel A's bound against its plain version at T = 1400
CP_HALO = 32
CP_VOC_SID = 7
# the vocoder against one process's whole decode on all but the outermost hop
# samples at each end, of the whole decode's peak: bf16 rounds the
# shards' and the whole's convs apart; f32 sees the halo's far reach
CP_VOC_TOL = {"bfloat16": 2 ** -5, "float32": 1e-3}
# within a halo of the shards' seam the f32 halo is exact up to rounding
CP_SEAM_TOL = {"float32": 1e-4}
CP_PIPE_M = (2, 4)
CP_SPEAKERS = (3, 17, 42, 99)   # the pipeline's 4 requests
CP_PIPE_TOL = 2 ** -5   # the pipeline against infer: bf16 decode, of the peak
CP_REPS = 3             # phase 4h: timed calls after the counted one
PIPE_PER_MB = {"rel_attention": 14, "wn_stack": 4, "mrf_stage": 1, "mrf_stage_folded": 1}


def _p2p_probe_rank(rank, port, op, root):
    """One of a pair of processes on ``cuda:0`` over gloo: ``op`` on a CUDA
    tensor handed to gloo as it is (the port stages it through the host).
    → ``root/probe_{op}_{rank}.json``: "bits equal", "wrong bits" or the
    error.  A crash leaves no file."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=20))
    n, peer = 1 << 16, 1 - rank
    mine = torch.randn(n, generator=torch.Generator().manual_seed(rank)).cuda()
    want = torch.randn(n, generator=torch.Generator().manual_seed(peer))
    got = torch.zeros(n, device="cuda")
    try:
        if op == "send/recv":
            for call, t in ((dist.send, mine), (dist.recv, got))[::1 if rank == 0 else -1]:
                call(t, peer)
        elif op == "isend/irecv":
            for work in (dist.isend(mine, peer), dist.irecv(got, peer)):
                work.wait()
        else:
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer),
                                                dist.P2POp(dist.irecv, got, peer)]):
                work.wait()
        verdict = "bits equal" if torch.equal(got.cpu(), want) else "wrong bits"
    except Exception as e:   # the verdict: what gloo does with a device pointer
        verdict = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:120]}"
    with open(os.path.join(root, f"probe_{op.replace('/', '_')}_{rank}.json"), "w") as f:
        json.dump(verdict, f)
    os._exit(0)   # no teardown: a failed gloo pair may hang in it


def p2p_probe(root):
    """gloo's point-to-point calls on CUDA tensors, each op in a pair of
    processes of its own, all started at once.  → ``verdicts()``, which
    waits for them: {op: [rank 0's verdict, rank 1's]}, "crashed (exit code
    n)" for a rank that left no verdict."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    pairs = {}
    for op in CP_PROBE_OPS:
        port = _free_port()
        pairs[op] = [ctx.Process(target=_p2p_probe_rank, args=(r, port, op, root))
                     for r in range(2)]
    t0 = time.perf_counter()
    for procs in pairs.values():
        for p in procs:
            p.start()

    def verdicts():
        out = {}
        for op, procs in pairs.items():
            for p in procs:
                p.join(max(t0 + CP_PROBE_TIMEOUT - time.perf_counter(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join(10)
            out[op] = []
            for r, p in enumerate(procs):
                path = os.path.join(root, f"probe_{op.replace('/', '_')}_{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        out[op].append(json.load(f))
                else:
                    out[op].append(f"crashed (exit code {p.exitcode})")
        return out

    return verdicts


def _counted_sends(torch, call):
    """``call()`` with the bytes this rank sends counted where the port
    sends them: ``p2p.shift`` and ``p2p.isend`` (point to point),
    ``all_gather`` ((P − 1) × its chunk) and ``broadcast`` ((P − 1) × the
    tensor, at the source).  → (the result, {kind: [calls, bytes]})."""
    import torch.distributed as dist

    from vispeech_tpu_torch.parallel import p2p

    counts = {}
    shift, isend, gather, bcast = p2p.shift, p2p.isend, dist.all_gather, dist.broadcast

    def add(kind, nbytes):
        c = counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes

    def size(t):
        return t.numel() * t.element_size()

    def counted_shift(t, group, offset=1):
        ts = (t,) if isinstance(t, torch.Tensor) else tuple(t)
        if p2p.size(group) > 1 and offset % p2p.size(group):
            add("shift", sum(size(x) for x in ts))
        return shift(t, group, offset)

    def counted_isend(t, group, dst, tag=0):
        add("isend", size(t))
        return isend(t, group, dst, tag)

    def counted_gather(parts, t, *a, **k):
        add("all_gather", (len(parts) - 1) * size(t))
        return gather(parts, t, *a, **k)

    def counted_bcast(t, src, group=None, *a, **k):
        add("broadcast", (dist.get_world_size(group) - 1) * size(t)
            if dist.get_rank() == src else 0)
        return bcast(t, src, group, *a, **k)

    p2p.shift, p2p.isend, dist.all_gather, dist.broadcast = (
        counted_shift, counted_isend, counted_gather, counted_bcast)
    try:
        out = call()
    finally:
        p2p.shift, p2p.isend, dist.all_gather, dist.broadcast = shift, isend, gather, bcast
    return out, counts


def _cp_run(torch, on_card, call, path):
    """Phase 4h's run of one configuration on a rank: the counted call (the
    launch counters reset just before it, read just after; the bytes it
    sends), its output saved to ``path``, then ``CP_REPS`` timed calls
    (host clock, synchronized).  Every rank makes the same calls."""
    from vispeech_tpu_torch.ops import kernels

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, sent = _counted_sends(torch, call)
    sync()
    first = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    torch.save(out.cpu(), path)
    walls = []
    for _ in range(CP_REPS):
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"launches": launches, "sent": sent, "first_ms": first, "wall_ms": walls}


def _f32_decode(model):
    """The vocoder in f32 on the engine's model (its frozen weights)."""
    return lambda z, g: model.dec(z.float(), None if g is None else g.float()).float()


def _cp_rank(rank, port, cfg, root, device):
    """One rank of phase 4h's 2-rank world on ``cuda:0`` over gloo
    (``device`` "cpu" for a rehearsal): the staged transport, the ring, the
    vocoder in bf16 and f32, the pipeline at each M.  → ``root/cp{rank}.json``
    and each output as ``root/cp_{name}_{rank}.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch

    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.parallel import (
        context_groups,
        make_generator_context_parallel,
        make_mesh,
        make_ring_attention,
        make_synthesizer_pipeline,
        shift,
    )

    on_card = device != "cpu"
    mesh = make_mesh(device=device, backend="gloo", init_method=f"tcp://127.0.0.1:{port}")
    rec = {"rank": rank, "device": str(mesh.device)}
    try:
        group, _ = context_groups(2)
        dev = mesh.device
        engine = TTSEngine(cfg, seeded_state_dict(torch, cfg), device=dev.type)
        model = engine.model
        inp = torch.load(os.path.join(root, "cp_inputs.pt"))
        mine = torch.randn(4096, generator=torch.Generator().manual_seed(rank))
        other = torch.randn(4096, generator=torch.Generator().manual_seed(1 - rank))
        rec["staged"] = {str(dt): bool(torch.equal(
            shift(mine.to(dev, dt), group, 1).cpu(), other.to(dt)))
            for dt in (torch.float32, torch.bfloat16)}

        def run(name, call):
            rec[name] = _cp_run(torch, on_card, call, os.path.join(root, f"cp_{name}_{rank}.pt"))

        with torch.no_grad(), engine.policy.precision():
            ring = make_ring_attention(group, CP_RING["w"])
            args = [t.to(dev) for t in inp["ring"]]
            run("ring", lambda: ring(*args))
            z = inp["voc_z"].to(dev)
            g = model._speaker(torch.tensor([CP_VOC_SID], device=dev))
            for dtype, apply in (("bfloat16", model._decode), ("float32", _f32_decode(model))):
                voc = make_generator_context_parallel(apply, group, cfg.data.hop_length, CP_HALO)
                run(f"vocoder_{dtype}", lambda: voc(z, g))
            ph, lens, sid, eps = (t.to(dev) for t in inp["pipe"])
            for M in CP_PIPE_M:
                pipe = make_synthesizer_pipeline(model, group, inp["bucket"], M)
                run(f"pipeline_{M}", lambda: pipe(ph, lens, sid, eps))
    finally:
        mesh.close()
    with open(os.path.join(root, f"cp{rank}.json"), "w") as f:
        json.dump(rec, f)


def _cp_inputs(torch, cfg, engine, dev):
    """Phase 4h's inputs, on the host: the ring's q, k, v, tables and key
    mask; the vocoder's latent [1, 1400, inter]; the pipeline's 4 requests
    (phase 3's batch texts with speakers ``CP_SPEAKERS`` in turn: the
    longest that fit the bucket of their largest plan, padded to one
    phoneme length), their speakers and prior noise."""
    import numpy as np

    from vispeech_tpu_torch.infer.batching import DEFAULT_TIERS, plan_batches
    from vispeech_tpu_torch.text import cleaned_text_to_sequence

    gen = torch.Generator().manual_seed(SEED)
    B, H, T, d, w = (CP_RING[k] for k in "BHTdw")
    qkv = [torch.randn(B, H, T, d, generator=gen) for _ in range(3)]
    tables = [torch.randn(2 * w + 1, d, generator=gen) * d ** -0.5 for _ in range(2)]
    mask = (torch.arange(T)[None, :] < torch.tensor(CP_RING["lengths"])[:, None]).float()
    inter = cfg.model.inter_channels
    voc_z = torch.randn(1, T, inter, generator=gen)

    _, batch_texts = serving_requests(torch, cfg)
    ids = [cleaned_text_to_sequence(engine.phonemes(t)) for t in batch_texts]
    sids = [CP_SPEAKERS[i % len(CP_SPEAKERS)] for i in range(len(ids))]
    ph = torch.zeros(len(ids), engine._n_pad(max(len(i) for i in ids)), dtype=torch.long)
    for r, i in enumerate(ids):
        ph[r, :len(i)] = torch.tensor(i)
    lens = torch.tensor([len(i) for i in ids])
    with engine.policy.precision():
        pred = engine._predicted_durations(ph.numpy(), lens.tolist(), sids)
    # the frames each request fills, as synthesize_batch reckons them
    totals = [max(int(np.ceil(np.maximum(p[:n], 0.0)).sum()), 1)
              for p, n in zip(pred, lens.tolist())]
    plan = max(plan_batches(totals, tiers=DEFAULT_TIERS),
               key=lambda p: (p.tier > 1, p.tier * p.bucket))
    fits = sorted(sorted((i for i, t in enumerate(totals) if t <= plan.bucket),
                         key=lambda i: -totals[i])[:len(CP_SPEAKERS)])
    n = engine._n_pad(max(len(ids[i]) for i in fits))
    eps = torch.randn(len(fits), plan.bucket, inter, generator=gen)
    pipe = (ph[fits, :n], lens[fits], torch.tensor([sids[i] for i in fits]), eps)
    return {"ring": qkv + tables + [mask], "voc_z": voc_z, "pipe": pipe,
            "bucket": plan.bucket, "plan": (plan.tier, plan.bucket),
            "frames": [totals[i] for i in fits]}


def _ends(got, want, hop, tol):
    """(the largest difference on all but the outermost ``hop`` samples at
    each end, samples beyond ``tol`` at the start and at the end, their
    reach from each end) for audio [1, S, 1]."""
    d = (got - want).abs()[0, :, 0]
    bad = (d > tol).nonzero().flatten().tolist()
    half = d.numel() // 2
    left = [i for i in bad if i < half]
    right = [d.numel() - i for i in bad if i >= half]
    return (float(d[hop:-hop].max()), len(left), len(right), max(left, default=-1) + 1,
            max(right, default=0))


def cp_phase(torch, cfg, root, record, device=None):
    """Phase 4h (also alone as ``--cp``): inference across devices on one
    card.  NCCL refuses two ranks on one device, so a world of two
    processes on ``cuda:0`` runs over gloo, whose point-to-point calls the
    port stages through the host (``device`` "cpu" rehearses it on the
    host: no probe, no launches, no NCCL run).  Prints gloo's verdict on
    CUDA tensors handed to its send/recv as they are (``p2p_probe``), then:

    - ring attention (P = 2) at the FramePriorNet's shapes (``CP_RING``), f32
      with TF32 off, against kernel A on the whole sequence and A's plain
      version, on valid rows (A masks keys only); its wall ms beside A's;
    - the overlap-save vocoder (P = 2, halo 32): the engine's full
      generator in its decode dtype (bf16) and in f32 on z [1, 1400, 192]
      with a speaker: C 1 and D 1 on each rank; against one process's whole
      decode on all but the outermost hop samples at each end
      (``CP_VOC_TOL``), and how many end samples differ (halo against
      padding);
    - the pipeline: the engine's Synthesizer on 4 requests at the bucket of
      phase 3's largest batched plan, seeded ``eps``, M = 2 and 4: rank 0
      launches A 14 a microbatch, rank 1 B 4, C 1 and D 1; against one
      process's ``infer`` microbatch by microbatch (expected bit-equal) and
      on the whole batch (``CP_PIPE_TOL``);
    - the bytes each rank sends (counted where the port sends them) and
      each call's wall ms: gloo's host staging, not NVLink: correctness and
      transport, not scaling;
    - beside the probe and the ranks, ``torchrun --nproc_per_node 1`` of
      this script's ``--cp-nccl``: the ring and the f32 vocoder on a 1-rank
      NCCL group against the whole, and the NCCL route's refusal of a CPU
      tensor; kernel A's and its plain version's times after it all, alone
      on the card.

    → both ranks' launches, summed."""
    import torch.multiprocessing as mp

    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops.kernels import rel_attention

    on_card = device != "cpu"
    device = device or "cuda"
    t_phase = time.perf_counter()
    # the probe's processes and the NCCL run overlap the untimed set-up
    verdicts = p2p_probe(root) if on_card else None
    engine = TTSEngine(cfg, seeded_state_dict(torch, cfg), device=device)
    model, dev = engine.model, engine.device
    inp = _cp_inputs(torch, cfg, engine, dev)
    torch.save(inp, os.path.join(root, "cp_inputs.pt"))
    hop = cfg.data.hop_length
    nccl = None
    if on_card:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env["PYTHONPATH"] = ROOT
        nccl = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", os.path.join(ROOT, "chip_smoke.py"), "--cp-nccl", root],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        probe = verdicts()
        print(f"cp: gloo point-to-point on CUDA tensors as they are (each op in a pair of "
              f"processes on cuda:0; rank 0's verdict, rank 1's): {probe}")
        record["probe"] = probe

    codes = None
    try:
        # one process's references (not counted: the counters are the ranks')
        refs = {}
        with torch.no_grad(), engine.policy.precision():
            q, k, v, rel_k, rel_v, mask = (t.to(dev) for t in inp["ring"])
            a_args = (q, k, v, rel_k[None], rel_v[None], mask, CP_RING["w"])
            refs["A"] = rel_attention.relative_self_attention(*a_args).cpu()
            refs["A plain"] = rel_attention.relative_self_attention_plain(*a_args).cpu()
            z = inp["voc_z"].to(dev)
            g = model._speaker(torch.tensor([CP_VOC_SID], device=dev))
            refs["vocoder_bfloat16"] = model._decode(z, g).cpu()
            refs["vocoder_float32"] = _f32_decode(model)(z, g).cpu()
            # what a wrong halo would move: the sign of the last frame of
            # rank 0's shard (rank 1's left halo)
            flipped = z.clone()
            flipped[:, z.shape[1] // 2 - 1] *= -1
            refs["seam moves"] = float(
                (_f32_decode(model)(flipped, g).cpu() - refs["vocoder_float32"]).abs().max())
            ph, lens, sid, eps = (t.to(dev) for t in inp["pipe"])
            T = inp["bucket"]
            for M in CP_PIPE_M:
                n = ph.shape[0] // M
                refs[f"pipeline_{M}"] = torch.cat([
                    model.infer(ph[i:i + n], lens[i:i + n], T, sid=sid[i:i + n],
                                noise_scale=0.667, eps=eps[i:i + n])[0].cpu()
                    for i in range(0, ph.shape[0], n)])
            refs["whole batch"] = model.infer(ph, lens, T, sid=sid, noise_scale=0.667,
                                              eps=eps)[0].cpu()
        del engine, model
        if on_card:
            torch.cuda.empty_cache()

        ctx = mp.get_context("spawn")
        port = _free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_cp_rank, args=(r, port, cfg, root, device)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(t0 + CP_TIMEOUT - time.perf_counter(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        print(f"cp: two ranks on {device} over gloo: exit codes {codes} in "
              f"{time.perf_counter() - t0:.1f} s")
    except BaseException:
        if nccl is not None and nccl.poll() is None:
            nccl.kill()
        raise
    finally:
        # the probe's processes and the NCCL run, waited for (killed after a
        # failure)
        if verdicts is not None and "probe" not in record:
            verdicts()
        stdout = stderr = ""
        if nccl is not None:
            try:
                stdout, stderr = nccl.communicate(timeout=CLI_TIMEOUT)
            finally:
                if nccl.poll() is None:
                    nccl.kill()
                    nccl.communicate()
    if codes != [0, 0]:
        raise AssertionError(f"phase 4h's ranks exited {codes} (None: hung)")
    fails = []
    if nccl is not None:
        print("\n".join(ln for ln in stdout.splitlines() if ln.startswith("cp-nccl:")))
        print(f"cp: torchrun --nproc_per_node 1 chip_smoke.py --cp-nccl (beside the probe and "
              f"the two ranks): exit {nccl.returncode}")
        if nccl.returncode != 0:
            print(stderr[-4000:])
            fails.append("the 1-rank NCCL run")
        # kernel A alone, with nothing else on the card
        with torch.no_grad():
            refs["A ms"] = time_ms(lambda: rel_attention.relative_self_attention(*a_args), 20)
            refs["A plain ms"] = time_ms(
                lambda: rel_attention.relative_self_attention_plain(*a_args), 5)
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"cp{r}.json")) as f:
            ranks.append(json.load(f))

    def out(name, r):
        return torch.load(os.path.join(root, f"cp_{name}_{r}.pt"))

    staged = [rk["staged"] for rk in ranks]
    print(f"cp: p2p.shift through the host (gloo, CUDA tensors), the bits the other rank "
          f"sent: {staged}")
    if not all(all(s.values()) for s in staged):
        fails.append("staged transport")
    for name in ("ring", "vocoder_bfloat16", "vocoder_float32",
                 *(f"pipeline_{M}" for M in CP_PIPE_M)):
        if not torch.equal(out(name, 0), out(name, 1)):
            fails.append(f"{name}: the ranks' outputs differ")

    def walls(name):
        return (f"first {ranks[0][name]['first_ms']:.2f} ms, then "
                f"{[round(x, 2) for x in ranks[0][name]['wall_ms']]} (rank 0)")

    def sent(name):
        return ", ".join(f"{k} {n} calls {b / 2 ** 20:.3f} MiB"
                         for k, (n, b) in sorted(ranks[0][name]["sent"].items()))

    card = card_line() if on_card else "host CPU"
    # ring attention against kernel A, valid rows
    ring = out("ring", 0)
    errs = {}
    for ref in ("A", "A plain"):
        errs[ref] = max(float((ring[b, :, :L] - refs[ref][b, :, :L]).abs().max())
                        for b, L in enumerate(CP_RING["lengths"]))
    ok = all(e <= CP_RING_TOL for e in errs.values())
    print(f"cp: ring attention, P = 2, [B, H, T, d] = {[CP_RING[k] for k in 'BHTd']}, key "
          f"lengths {list(CP_RING['lengths'])}, f32 (TF32 off), against kernel A on the whole "
          f"sequence {errs['A']:.3e}, its plain version {errs['A plain']:.3e} on valid rows "
          f"(bound {CP_RING_TOL:.0e}) {'ok' if ok else 'FAIL'}; wall {walls('ring')}; kernel "
          f"A alone {refs.get('A ms', float('nan')):.4f} ms, its plain version "
          f"{refs.get('A plain ms', float('nan')):.4f} ms; sends {sent('ring')} (gloo's host "
          f"staging, not NVLink); {card}")
    if not ok:
        fails.append("ring")
    record["ring"] = {"err": errs, "rank0": ranks[0]["ring"], "A_ms": refs.get("A ms"),
                      "A_plain_ms": refs.get("A plain ms")}

    for dtype, tol in CP_VOC_TOL.items():
        name = f"vocoder_{dtype}"
        got, want = out(name, 0), refs[name]
        peak = float(want.abs().max())
        inner, n_left, n_right, reach_l, reach_r = _ends(got, want, hop, tol * peak)
        # the samples within a halo of the shards' seam, where a wrong halo shows
        mid = got.shape[1] // 2
        seam = float((got - want)[:, mid - CP_HALO * hop:mid + CP_HALO * hop].abs().max())
        seam_tol = CP_SEAM_TOL.get(dtype, tol)
        ok = got.shape == want.shape and inner <= tol * peak and seam <= seam_tol * peak
        print(f"cp: overlap-save vocoder, P = 2, halo {CP_HALO}, {dtype}, z {list(z.shape)}: "
              f"{got.shape[1]} samples against one process's whole decode: on all but the "
              f"outermost {hop} samples at each end {inner:.3e} ({inner / peak:.3e} of the peak "
              f"{peak:.3e}, bound {tol:.3g}), within a halo of the seam {seam:.3e} ("
              f"{seam / peak:.3e}, bound {seam_tol:.3g}) {'ok' if ok else 'FAIL'}; samples "
              f"beyond the bound {n_left} at the start (reaching {reach_l}) and {n_right} at "
              f"the end (reaching {reach_r}); wall {walls(name)}; sends {sent(name)}")
        if not ok:
            fails.append(name)
        record[name] = {"inner": inner, "seam": seam, "peak": peak, "ends": [n_left, n_right],
                        "reach": [reach_l, reach_r], "rank0": ranks[0][name]}
    # the f32 seam check sees a wrong halo only if a halo frame moves the audio
    peak = record["vocoder_float32"]["peak"]
    moves = refs["seam moves"]
    ok = moves >= 10 * CP_SEAM_TOL["float32"] * peak
    print(f"cp: one latent frame's sign at the seam moves the whole f32 decode by {moves:.3e} "
          f"({moves / peak:.3e} of the peak, {moves / (CP_SEAM_TOL['float32'] * peak):.1f} x "
          f"the seam's bound; at least 10 x) {'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("the seam check cannot see a wrong halo")
    record["seam_moves"] = moves

    for M in CP_PIPE_M:
        name = f"pipeline_{M}"
        got = out(name, 0)
        per_mb, whole = refs[name], refs["whole batch"]
        peak = float(whole.abs().max())
        d_mb = float((got - per_mb).abs().max()) if got.shape == per_mb.shape else float("inf")
        d_whole = float((got - whole).abs().max()) if got.shape == whole.shape else float("inf")
        ok = d_mb <= CP_PIPE_TOL * peak and d_whole <= CP_PIPE_TOL * peak
        print(f"cp: pipeline, 2 stages, M = {M}, {got.shape[0]} requests of "
              f"{inp['frames']} frames at bucket {inp['bucket']} (phase 3's largest plan "
              f"{inp['plan']}): against one process's infer microbatch by microbatch "
              f"{'bit-equal' if d_mb == 0 else f'{d_mb:.3e} apart (not bit-equal)'}, against "
              f"one whole-batch infer {d_whole:.3e} ({d_whole / peak:.3e} of the peak; bound "
              f"{CP_PIPE_TOL:.3g} of it) {'ok' if ok else 'FAIL'}; wall {walls(name)}; rank 0 "
              f"sends {sent(name)}; rank 1 sends "
              + ", ".join(f"{k} {n} calls {b / 2 ** 20:.3f} MiB"
                          for k, (n, b) in sorted(ranks[1][name]["sent"].items())))
        if not ok:
            fails.append(name)
        record[name] = {"per_mb": d_mb, "whole": d_whole, "peak": peak,
                        "ranks": [rk[name] for rk in ranks]}

    counts = {}
    for r, rk in enumerate(ranks):
        for name in ("ring", "vocoder_bfloat16", "vocoder_float32",
                     *(f"pipeline_{M}" for M in CP_PIPE_M)):
            for k, v in rk[name]["launches"].items():
                counts[k] = counts.get(k, 0) + v
    if on_card:
        for r, rk in enumerate(ranks):
            want = {}
            for M in CP_PIPE_M:
                for k, v in PIPE_PER_MB.items():
                    if (k == "rel_attention") == (r == 0):
                        want[k] = want.get(k, 0) + v * M
            for dtype in CP_VOC_TOL:
                for k in ("mrf_stage", "mrf_stage_folded"):
                    want[k] = want.get(k, 0) + 1
            got = {k: sum(rk[n]["launches"][k] for n in rk if n.startswith(("ring", "voc",
                                                                               "pipe")))
                   for k in PIPE_PER_MB}
            want = {k: want.get(k, 0) for k in PIPE_PER_MB}
            per = {n: {k: v for k, v in rk[n]["launches"].items() if v}
                   for n in rk if n.startswith(("ring", "voc", "pipe"))}
            print(f"cp: rank {r}'s launches {per}; A-D over the phase {got}, expected {want}")
            if got != want:
                fails.append(f"rank {r}'s launches")

    print(f"cp: phase 4h in {time.perf_counter() - t_phase:.1f} s")
    if fails:
        raise AssertionError(f"phase 4h failed: {fails}")
    record["launches"] = counts
    return counts


def cp_nccl(torch, root) -> int:
    """``--cp-nccl`` under ``torchrun --nproc_per_node 1`` (phase 4h): a
    1-rank NCCL world; the ring (P = 1) against kernel A and the f32
    vocoder (P = 1) against the whole decode on phase 4h's inputs, both on
    the world group (its gathers run through NCCL); ``p2p.shift`` on it
    returns its input; a CPU tensor on it is refused.  Exit 0 when all
    hold."""
    import torch.distributed as dist

    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.ops.kernels import rel_attention
    from vispeech_tpu_torch.parallel import (
        make_generator_context_parallel,
        make_mesh,
        make_ring_attention,
        p2p,
    )
    from vispeech_tpu_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
    mesh = make_mesh()
    world = dist.group.WORLD
    ok = {}
    try:
        dev = mesh.device
        print(f"cp-nccl: backend {dist.get_backend(world)}, world {dist.get_world_size()}, "
              f"{dev}")
        x = torch.ones(4, device=dev)
        ok["shift returns its input"] = p2p.shift(x, world, 1) is x
        try:
            p2p.staged(torch.device("cpu"), world)
            ok["a CPU tensor refused"] = False
        except RuntimeError as e:
            ok["a CPU tensor refused"] = "no point-to-point route" in str(e)
        inp = torch.load(os.path.join(root, "cp_inputs.pt"))
        engine = TTSEngine(cfg, seeded_state_dict(torch, cfg), device="cuda")
        model = engine.model
        with torch.no_grad(), engine.policy.precision():
            q, k, v, rel_k, rel_v, mask = (t.to(dev) for t in inp["ring"])
            kernels.reset_launches()
            ring = make_ring_attention(world, CP_RING["w"])(q, k, v, rel_k, rel_v, mask)
            ring_launches = kernels.launch_counts()["rel_attention"]
            want = rel_attention.relative_self_attention(q, k, v, rel_k[None], rel_v[None],
                                                         mask, CP_RING["w"])
            err = max(float((ring[b, :, :L] - want[b, :, :L]).abs().max())
                      for b, L in enumerate(CP_RING["lengths"]))
            ok["ring"] = err <= CP_RING_TOL and ring_launches == 0
            print(f"cp-nccl: ring attention, P = 1, against kernel A on valid rows {err:.3e} "
                  f"(bound {CP_RING_TOL:.0e}), A launches in the ring {ring_launches}")
            z = inp["voc_z"].to(dev)
            g = model._speaker(torch.tensor([CP_VOC_SID], device=dev))
            decode = _f32_decode(model)
            kernels.reset_launches()
            got = make_generator_context_parallel(decode, world, cfg.data.hop_length,
                                                  CP_HALO)(z, g)
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
            want = decode(z, g)
            peak = float(want.abs().max())
            tol = CP_VOC_TOL["float32"]
            inner, n_left, n_right, reach_l, reach_r = _ends(got.cpu(), want.cpu(),
                                                             cfg.data.hop_length, tol * peak)
            ok["vocoder"] = inner <= tol * peak and launches == {"mrf_stage": 1,
                                                                 "mrf_stage_folded": 1}
            print(f"cp-nccl: overlap-save vocoder, P = 1, f32, against the whole decode on all "
                  f"but the outermost {cfg.data.hop_length} samples at each end {inner:.3e} "
                  f"({inner / peak:.3e} of the peak, bound {tol:.0e}); beyond the bound "
                  f"{n_left} samples at the start (reaching {reach_l}), {n_right} at the end "
                  f"(reaching {reach_r}); launches {launches}")
    finally:
        mesh.close()
    print(f"cp-nccl: {ok}")
    return 0 if all(ok.values()) else 1


FOLD_BATCH = 12    # phase 4f: the trainer's batch (configs/config.json)
FOLD_TOL = 1e-5    # phase 4f: f64 (weights folded in f32): each gradient within this of its peak
FOLD_REPS = 3      # phase 4f: forward + backward calls a profiled window


def fold_phase(torch, cfg, record, dev=None, batch=FOLD_BATCH):
    """Phase 4f (also alone as ``--fold``): the training decoder's MRF
    stages of at most 64 channels (C = 64 at T = 8192 and C = 32 at
    T = 16 384 samples for a 16 384-sample segment) at batch 12, the
    folded stage (``ops/folded_mrf.py``, fold 128 // C) against the plain
    ResBlock1 stage, forward and backward.  First the gradients of x and
    of every weight of the two routes held against each other in f64
    (each within ``FOLD_TOL`` of its peak: the same math, summed in
    another order, both routes' weights in f64: f64 holds the routes' math
    apart from cuDNN's f32 rounding, which on either route is far larger,
    and a leaky ReLU's kink turns a weight's rounding into a gradient's
    jump); then each route's
    device time a forward + backward
    (torch.profiler, ``FOLD_REPS`` calls) in bf16 (the default tail_f32
    decoder body) and in f32 with TF32 on (the f32 option's step), and the
    two routes' gradients in each.  ``record`` gets a row a stage."""
    import copy
    import math

    from vispeech_tpu_torch.models.generator import Generator
    from vispeech_tpu_torch.models.synthesizer import random_init_
    from vispeech_tpu_torch.ops import folded_mrf
    from vispeech_tpu_torch.train.step import tf32_mode

    dev = dev or torch.device("cuda")
    m = cfg.model
    gen = random_init_(Generator(m.inter_channels, m.resblock, m.resblock_kernel_sizes,
                                 m.resblock_dilation_sizes, m.upsample_rates,
                                 m.upsample_initial_channel, m.upsample_kernel_sizes), SEED)
    n = len(gen.kernel_sizes)
    rng = torch.Generator().manual_seed(SEED)
    for i, ch in enumerate(gen.channels):
        if ch > 64:
            continue
        T = cfg.train.segment_size // math.prod(m.upsample_rates[i + 1:])
        fold = 128 // ch
        x0 = torch.randn(batch, ch, T, generator=rng).to(dev)
        dy = torch.randn(batch, ch, T, generator=rng).to(dev)
        row = {"T": T, "fold": fold}

        def routes(blocks):
            def plain(x):
                return sum(b.forward_cf(x) for b in blocks) / n

            def folded(x):
                return folded_mrf.mrf_stage_folded(
                    x.transpose(1, 2), [b.packed() for b in blocks], gen.kernel_sizes,
                    gen.dilations, fold).transpose(1, 2)
            return {"plain": plain, "folded": folded}

        def grads(fn, blocks, x):
            x = x.clone().requires_grad_(True)
            return torch.autograd.grad(fn(x), [x, *blocks.parameters()], dy.to(x.dtype))

        def worst(a, b):
            return max(float((u.float() - v.float()).abs().max())
                       / max(float(v.float().abs().max()), 1e-30) for u, v in zip(a, b))

        f64 = copy.deepcopy(gen.resblocks[i * n:(i + 1) * n]).to(dev, torch.float64)
        r = routes(f64)
        err = worst(grads(r["folded"], f64, x0.double()), grads(r["plain"], f64, x0.double()))
        ok = err <= FOLD_TOL
        print(f"fold: C = {ch} at T = {T}, fold {fold}, batch {batch}: f64 gradients of x and "
              f"{len(list(f64.parameters()))} weights, folded vs plain, worst {err:.3e} of "
              f"each peak (tol {FOLD_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"C = {ch}: folded and plain gradients differ by {err:.3e}")
        row["f64_grad_err"] = err
        for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            blocks = copy.deepcopy(f64).to(dtype)
            x = x0.to(dtype).requires_grad_(True)
            r = routes(blocks)
            times = {}
            with tf32_mode(True):
                row[f"{label}_grad_err"] = worst(grads(r["folded"], blocks, x0.to(dtype)),
                                                 grads(r["plain"], blocks, x0.to(dtype)))
                for name, fn in r.items():
                    def fwd_bwd(fn=fn):
                        for _ in range(FOLD_REPS):
                            torch.autograd.backward(fn(x), dy.to(dtype))
                    fwd_bwd()
                    prof = {}
                    profile(torch, f"fold C = {ch} {label} {name} x{FOLD_REPS}", fwd_bwd, 3,
                            prof)
                    times[name] = prof.get("busy_ms", float("nan")) / FOLD_REPS
            row[label] = times
            print(f"fold: C = {ch} at T = {T} {label}: forward + backward device time a call "
                  f"plain {times['plain']:.4f} ms, folded {times['folded']:.4f} ms "
                  f"(folded / plain {times['folded'] / times['plain']:.3f}); gradients folded "
                  f"vs plain worst {row[label + '_grad_err']:.3e} of each peak; {card_line()}")
            del blocks, x
        record[f"C={ch}"] = row
        del f64, x0, dy
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# phase 4i's bounds, card (f32, TF32 off) against the host CPU: the SDP's
# logw absolute (a logw of ~1.8 through three inverse splines and twelve
# DDSConv layers: f32 summation order, ~1e-6, amplified where a bin is
# narrow; the CPU tests hold the port to JAX at the same bound), its NLL
# relative (a sum of ~400 terms), a duration compared only where w lies
# farther than SDP_MARGIN from an integer (a ceil; w = 1.1·(e^logw − 1)
# moves by ~7e-4 at logw's bound), the Conformer, Decoder and FFT outputs
# relative to their peaks (four post-norm layers, f32)
SDP_LOGW_TOL = 1e-4
SDP_NLL_RTOL = 1e-4
SDP_MARGIN = 1e-3
OFFPATH_TOL = 1e-4
SDP_SCALE = 1.1          # phase 4i's scalar duration control
SDP_REPS = 5             # phase 4i: timed calls of each duration head


def _seeded_params_(torch, module, seed):
    """Every parameter of ``module`` from ``torch.Generator(seed)``: norm
    scales 1 + N(0, 0.1²), running variances U(0.5, 1.5), running means
    N(0, 0.1²), the rest U(±1/√fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in [*module.named_parameters(), *module.named_buffers()]:
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(p.shape, generator=gen)
            elif name.endswith("running_mean"):
                v = 0.1 * torch.randn(p.shape, generator=gen)
            elif name.endswith(("gamma", "norm.weight", "bn.weight")):
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            else:
                fan_in = p[0].numel() if p.dim() > 1 else p.shape[-1]
                v = (torch.rand(p.shape, generator=gen) * 2 - 1) / fan_in ** 0.5
            p.copy_(v.to(p.device, p.dtype))
    return module


def _offpath_modules(torch, dev):
    """Phase 4i (e): ``ConformerEncoder(192, 4 layers, kernel 31)``, the
    causal ``Decoder`` and ``FFT`` at hidden 192 (filter 768, 2 heads, 4
    layers, kernel 3) over a batch of a 1400- and an 1100-frame item (the
    Decoder over 350- and 270-step encoder states), each on the card
    against the CPU: → {name: row}."""
    from vispeech_tpu_torch.models.conformer import ConformerEncoder
    from vispeech_tpu_torch.ops.attention import FFT, Decoder
    from vispeech_tpu_torch.ops.masking import length_mask

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(2, 1400, 192, generator=gen)
    h = torch.randn(2, 350, 192, generator=gen)
    x_mask = length_mask(torch.tensor([1400, 1100]), 1400)
    h_mask = length_mask(torch.tensor([350, 270]), 350)
    cases = {
        "conformer": (lambda: ConformerEncoder(192, n_layers=4, conv_kernel_size=31),
                      (x, x_mask)),
        "decoder": (lambda: Decoder(192, 768, 2, 4, kernel_size=3), (x, x_mask, h, h_mask)),
        "fft": (lambda: FFT(192, 768, 2, 4, kernel_size=3), (x, x_mask)),
    }
    rows = {}
    for i, (name, (make, args)) in enumerate(cases.items()):
        cpu = _seeded_params_(torch, make(), SEED + i).eval()
        card = _seeded_params_(torch, make(), SEED + i).to(dev).eval()
        on_card = [a.to(dev) for a in args]
        with torch.no_grad():
            t0 = time.perf_counter()
            want = cpu(*args)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            got = card(*on_card).cpu()
            prof = {}
            profile(torch, f"{name} [2, 1400]", lambda: card(*on_card), 4, prof)
        peak = float(want.abs().max())
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= OFFPATH_TOL * peak
        rows[name] = dict(max_abs_err=err, peak=peak, ok=ok, wall_ms=prof.get("wall_ms"),
                          device_ms=prof.get("busy_ms"), cpu_ms=cpu_ms)
        print(f"sdp (e): {name} at hidden 192, [2, 1400] frames: card vs CPU max_abs_err "
              f"{err:.3e} of peak {peak:.3e} (tol {OFFPATH_TOL:g} of peak) "
              f"{'ok' if ok else 'FAIL'}; wall {prof.get('wall_ms', float('nan')):.3f} ms, "
              f"device busy {prof.get('busy_ms', float('nan')):.3f} ms a call, CPU "
              f"{cpu_ms:.1f} ms; {card_line()}")
        del card, on_card
    return rows


def sdp_phase(torch, cfg, record, dev=None):
    """Phase 4i: the stochastic duration predictor at the full width of
    ``cfg`` with ``model.use_sdp`` set true (in memory), the weights of
    ``seeded_state_dict``; f32 with TF32 off, card against the host CPU.
    (a) its sampling and (b) its NLL at the long request's phoneme count,
    noise injected, on the same text states; (c) ``Synthesizer.infer`` with
    a scalar duration control, noise 0.667, ``eps_w`` and ``eps`` injected:
    its launches (A 14, B 4, C 1, D 1), durations equal where w lies beyond
    ``SDP_MARGIN`` of an integer, audio within 1e-3 of the peak when all
    durations agree; (d) the engine with ``use_sdp`` true and false on the
    same weights and seeds: int16 PCM bit-equal; (e) the Conformer,
    Decoder and FFT (``_offpath_modules``).  Prints the SDP's and the
    deterministic head's wall and device time for one request.  → the
    launch counts of (c) and (d)."""
    import numpy as np

    from vispeech_tpu_torch.infer.batching import pick_bucket
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.models.synthesizer import Synthesizer
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.ops.layers import freeze_weight_norm
    from vispeech_tpu_torch.ops.policy import FLOAT32
    from vispeech_tpu_torch.text import N_SYMBOLS, cleaned_text_to_sequence, text_to_phones

    dev = dev or torch.device("cuda")
    t_phase = time.perf_counter()
    fails = []
    sdp_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_sdp=True))
    state = seeded_state_dict(torch, sdp_cfg)
    models = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = Synthesizer.from_config(sdp_cfg, N_SYMBOLS, FLOAT32)
        m.load_state_dict(state)
        models[name] = freeze_weight_norm(m.to(device).eval())
    card, cpu = models["card"], models["cpu"]
    requests, _ = serving_requests(torch, cfg)
    label, kw, _ = requests[1]
    ids = cleaned_text_to_sequence(text_to_phones(kw["text"]))
    N = len(ids)
    ph, lens = torch.tensor([ids]), torch.tensor([N])
    sid = torch.tensor([kw["speaker"]])
    gen = torch.Generator().manual_seed(SEED)
    eps_w = torch.randn(1, N, 2, generator=gen)
    e_q = torch.randn(1, N, 2, generator=gen)

    def on(t):
        return t.to(dev)

    # (a) and (b): both predictors on the CPU's text states
    with torch.no_grad():
        x, x_mask = cpu.enc_p(ph, lens)
        g = cpu._speaker(sid)
        logw = {"cpu": cpu.sdp(x, x_mask, g=g, reverse=True, noise_scale=0.667,
                               noise=eps_w),
                "card": card.sdp(on(x), on(x_mask), g=on(g), reverse=True,
                                 noise_scale=0.667, noise=on(eps_w)).cpu()}
        w = (torch.exp(logw["cpu"]) * x_mask - 1.0) * SDP_SCALE
        dur = torch.clamp(torch.ceil(w), min=0.0)
        nll = {"cpu": cpu.sdp(x, x_mask, w=dur, g=g, noise=e_q),
               "card": card.sdp(on(x), on(x_mask), w=on(dur), g=on(g), noise=on(e_q)).cpu()}
    err_w = float((logw["card"] - logw["cpu"]).abs().max())
    err_nll = float(((nll["card"] - nll["cpu"]).abs() / nll["cpu"].abs()).max())
    frames = dur[0, :, 0].tolist()
    print(f"sdp: N = {N} phonemes ('{label}' text), speaker {int(sid)}; frames a phoneme at "
          f"scale {SDP_SCALE}: min {min(frames):.0f}, mean {sum(frames) / N:.2f}, max "
          f"{max(frames):.0f}, total {sum(frames):.0f}")
    ok_a = bool(torch.isfinite(logw["card"]).all()) and err_w <= SDP_LOGW_TOL
    ok_b = bool(torch.isfinite(nll["card"]).all()) and err_nll <= SDP_NLL_RTOL
    print(f"sdp (a): sampling (noise 0.667, injected) card vs CPU: logw max_abs_err "
          f"{err_w:.3e} (tol {SDP_LOGW_TOL:g}) {'ok' if ok_a else 'FAIL'}")
    print(f"sdp (b): NLL (e_q injected) card {float(nll['card'][0]):.4f} vs CPU "
          f"{float(nll['cpu'][0]):.4f}: relative err {err_nll:.3e} (tol {SDP_NLL_RTOL:g}) "
          f"{'ok' if ok_b else 'FAIL'}")
    fails += [] if ok_a else ["(a) sampling"]
    fails += [] if ok_b else ["(b) NLL"]
    record.update(N=N, frames=sum(frames), logw_err=err_w, nll_rel_err=err_nll)

    # (c) infer through the kernels, counted
    t_frames = pick_bucket(int(sum(frames)))
    eps = torch.randn(1, t_frames, cfg.model.inter_channels, generator=gen)
    args = dict(sid=sid, noise_scale=0.667, duration_control=SDP_SCALE, eps=eps, eps_w=eps_w)
    card_args = {k: on(v) if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    card.infer(on(ph), on(lens), t_frames, **card_args)      # meets the shapes once
    torch.cuda.synchronize()
    kernels.reset_launches()
    out_card = card.infer(on(ph), on(lens), t_frames, **card_args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    out_cpu = cpu.infer(ph, lens, t_frames, **args)
    expect = {k: 0 for k in counts}
    expect.update(rel_attention=cfg.model.n_layers + 6 + cfg.model.n_layers, wn_stack=4,
                  mrf_stage=1, mrf_stage_folded=1)
    print(f"sdp (c): infer with use_sdp at bucket {t_frames}: launches {counts}, expected "
          f"{expect}")
    if counts != expect:
        fails.append("(c) launches")
    d_card, d_cpu = out_card[3].cpu()[0], out_cpu[3][0]
    clear = (w[0, :, 0] - torch.round(w[0, :, 0])).abs() > SDP_MARGIN
    agree = bool(torch.equal(d_card, d_cpu))
    ok_d = bool(torch.equal(d_card[clear], d_cpu[clear]))
    print(f"sdp (c): durations card vs CPU: {int(clear.sum())} of {N} beyond {SDP_MARGIN:g} "
          f"of an integer, equal there: {ok_d}; all equal: {agree}")
    if not ok_d:
        fails.append("(c) durations")
    a_card, a_cpu = out_card[0].cpu(), out_cpu[0]
    audio_ok = bool(torch.isfinite(a_card).all())
    if agree:
        err = float((a_card - a_cpu).abs().max())
        peak = float(a_cpu.abs().max())
        audio_ok = audio_ok and err <= 1e-3 * max(peak, 1e-3)
        print(f"sdp (c): audio card vs CPU: {a_cpu.shape[1]} samples, max_abs_err {err:.3e}, "
              f"peak {peak:.3e} (tol 1e-3 of peak) {'ok' if audio_ok else 'FAIL'}")
        record.update(audio_err=err, audio_peak=peak)
    else:
        print("sdp (c): a duration within the margin differs: audio not compared")
    if not audio_ok:
        fails.append("(c) audio")

    # the duration heads' time for one request, on the card
    with torch.no_grad():
        xc, mc, gc, nc = on(x), on(x_mask), on(g), on(eps_w)
        heads = {"sdp": lambda: card.sdp(xc, mc, g=gc, reverse=True, noise_scale=0.667,
                                         noise=nc),
                 "deterministic": lambda: card.duration_predictor(xc, mc, g=gc)}
        for name, fn in heads.items():
            walls = []
            for _ in range(SDP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            # the SDP's host dispatch outruns device_ms's head start: its
            # device time is the profiler's busy time over SDP_REPS calls
            prof = {}
            profile(torch, f"{name} duration head (N = {N}) x{SDP_REPS}",
                    lambda fn=fn: [fn() for _ in range(SDP_REPS)], 6, prof)
            wall = sorted(walls)[SDP_REPS // 2]
            record[f"{name}_ms"] = dict(wall=wall,
                                        device=prof.get("busy_ms", float("nan")) / SDP_REPS)
            print(f"sdp: {name} duration head, N = {N}: wall {wall:.3f} ms (median of "
                  f"{SDP_REPS}), device busy {record[f'{name}_ms']['device']:.4f} ms a call; "
                  f"{card_line()}")
    del models, card, cpu
    torch.cuda.empty_cache()

    # (d) the engine with use_sdp true and false: the same PCM
    no_sdp = {k: v for k, v in state.items() if not k.startswith("sdp.")}
    pcm = {}
    kernels.reset_launches()
    for flag, c, sd in ((True, sdp_cfg, state), (False, cfg, no_sdp)):
        engine = TTSEngine(c, sd, device=dev.type, transfer_int16=True)
        pcm[flag] = [engine.synthesize(**requests[0][1])["audio_int16"],
                     engine.synthesize(text=requests[0][1]["text"], speaker=9, seed=4,
                                       duration_control=SDP_SCALE)["audio_int16"]]
        del engine
    engine_counts = kernels.launch_counts()
    same = all(np.array_equal(a, b) for a, b in zip(pcm[True], pcm[False]))
    print(f"sdp (d): engine with use_sdp true vs false, 2 requests: int16 PCM bit-equal "
          f"{same} ({[len(a) for a in pcm[True]]} samples); launches {engine_counts}")
    if not same:
        fails.append("(d) engine PCM")
    torch.cuda.empty_cache()

    record["offpath"] = _offpath_modules(torch, dev)
    fails += [f"(e) {k}" for k, r in record["offpath"].items() if not r["ok"]]
    print(f"sdp: phase 4i in {time.perf_counter() - t_phase:.1f} s")
    if fails:
        raise AssertionError(f"phase 4i failed: {fails}")
    return {k: counts[k] + engine_counts[k] for k in counts}


def seeded_state_dict(torch, cfg) -> dict:
    """The serving phases' weights: drawn from ``SEED`` at the config's
    width, the duration head biased, since random weights predict
    meaningless durations, so a phoneme lasts about e^1.8 − 1 ≈ 5 frames.
    With ``model.use_sdp`` the stochastic duration predictor (registered
    last, so the other weights are the same) is biased likewise: its
    sampling ends in the affine logw = (z − m)·e^−logs, set to
    1.8 + z/e^1.2."""
    import math

    from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
    from vispeech_tpu_torch.text import N_SYMBOLS

    model = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed=SEED)
    with torch.no_grad():
        model.duration_predictor.proj.weight.mul_(0.1)
        model.duration_predictor.proj.bias.fill_(1.8)
        if model.sdp is not None:
            affine = model.sdp.flows[0]
            affine.logs[0] = 1.2
            affine.m[0] = -1.8 * math.exp(1.2)
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
    if sys.argv[1:] == ["--text"]:
        from vispeech_tpu_torch.infer.pipeline import TTSEngine

        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
        engine = TTSEngine(cfg, seeded_state_dict(torch, cfg), device=dev.type,
                           transfer_int16=True)
        counts, rows = text_phase(torch, cfg, engine)
        print(json.dumps({"root": ROOT, "card": card_line(), "launches": counts,
                          "text": rows}))
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
    if sys.argv[1:] == ["--trainer"]:
        rec = {}
        root = tempfile.mkdtemp(prefix="vispeech_trainer_")
        try:
            cfg = load_config(os.path.join(ROOT, "configs", "config.json"))
            _, trainer = trainer_phase(torch, cfg, root, rec)
            bf16_phase(torch, cfg, trainer, rec)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"root": ROOT, "card": card_line(), **rec}))
        return 0
    if sys.argv[1:] == ["--ddp"]:
        _build.build_all()
        rec = {}
        root = tempfile.mkdtemp(prefix="vispeech_ddp_")
        try:
            ddp_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")), root,
                      rec)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"root": ROOT, "card": card_line(), "ddp": rec}, default=str))
        return 0
    if sys.argv[1:] == ["--tp"]:
        _build.build_all()
        rec = {}
        root = tempfile.mkdtemp(prefix="vispeech_tp_")
        try:
            tp_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")), root,
                     rec)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"root": ROOT, "card": card_line(), "tp": rec}, default=str))
        return 0
    if sys.argv[1:] == ["--cp"]:
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rec = {}
        root = tempfile.mkdtemp(prefix="vispeech_cp_")
        try:
            cp_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")), root,
                     rec)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"root": ROOT, "card": card_line(), "cp": rec}, default=str))
        return 0
    if sys.argv[1:] == ["--sdp"]:
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rec = {}
        counts = sdp_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")),
                           rec)
        print(json.dumps({"root": ROOT, "card": card_line(), "launches": counts, "sdp": rec}))
        return 0
    if sys.argv[1:2] == ["--cp-nccl"] and len(sys.argv) == 3:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return cp_nccl(torch, sys.argv[2])
    if sys.argv[1:] == ["--fold"]:
        rec = {}
        fold_phase(torch, load_config(os.path.join(ROOT, "configs", "config.json")), rec)
        print(json.dumps({"root": ROOT, "card": card_line(), "fold": rec}))
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
    text_counts, _ = text_phase(torch, cfg, engine)
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
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vispeech_trainer_")
    try:
        trainer_counts, trainer = trainer_phase(torch, cfg, root, {})
        bf16_phase(torch, cfg, trainer, {})
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vispeech_ddp_")
    try:
        ddp_counts = ddp_phase(torch, cfg, root, {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fold_phase(torch, cfg, {})
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vispeech_tp_")
    try:
        tp_counts = tp_phase(torch, cfg, root, {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vispeech_cp_")
    try:
        cp_counts = cp_phase(torch, cfg, root, {})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    sdp_counts = sdp_phase(torch, cfg, {})

    # A, B, C and D count the serving run, the VC run, the text phase, the
    # HTTP phase, the trainer's evals, the model group's eval (rank 0's),
    # both ranks of phase 4h and phase 4i's infer and engines; E and F the
    # training run, the 1-rank mesh's and the model axis's (rank 0's)
    counts = {k: v + vc_counts[k] + text_counts[k] + http_counts[k]
              + trainer_counts.get(k, 0) + tp_counts.get(k, 0) + cp_counts.get(k, 0)
              + sdp_counts[k] for k, v in counts.items()}
    counts.update({k: v + ddp_counts[k] + tp_counts[k] for k, v in train_counts.items()
                   if "_train_" in k})
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
