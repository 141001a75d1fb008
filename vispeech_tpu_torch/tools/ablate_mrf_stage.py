"""Where kernel C's time goes: copies of ``csrc/mrf_stage.cu`` with one part
of its bf16 path taken out, each built with nvcc and timed on the card
(device time with the calls queued ahead) at B = 1, C = 64, k = 3, 7, 11,
dilations 1, 3, 5: the 128- and 1400-frame buckets' C = 64 stage (32 768
and 358 400 samples).

    python -m vispeech_tpu_torch.tools.ablate_mrf_stage

A variant without a part computes garbage (its error against the plain
version is printed beside its time); only the full kernel is right.  The
time a part costs is the full kernel's time less the variant's, as far as
the parts do not overlap.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from vispeech_tpu_torch.ops.kernels import _build, mrf_stage
from vispeech_tpu_torch.tools import _ablate

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3
SHAPES = ((1, 128 * 256), (1, 1400 * 256))

VARIANTS = {
    "full": [],
    "no wgmma": [("    for (int ks = 0; ks < C / 16; ++ks)\n      wgmma_m64n64k16(",
                  "    for (int ks = 0; ks < 0; ++ks)\n      wgmma_m64n64k16(")],
    "no epilogue": [("  mbar_arrive_if(ring.empty + prev, lane == 0);\n\n  const int wlo",
                     "  mbar_arrive_if(ring.empty + prev, lane == 0);\n  return;\n  const int wlo")],
    # neither side waits: the consumers would run phases ahead of a producer
    # that waits on their arrivals
    "no weight stream": [
        ("      mbar_wait(ring.full + slot, (it / NSLOT) & 1);\n      mbar_arrive_if(",
         "      mbar_arrive_if("),
        ("    mbar_wait(ring.full + slot, (it / NSLOT) & 1);\n    const __nv_bfloat16* a = src",
         "    const __nv_bfloat16* a = src"),
        ("        if (i >= NSLOT) mbar_wait(ring.empty + slot, ((i / NSLOT) - 1) & 1);\n"
         "        bulk_load(", "        if (false) bulk_load(")],
    "no unit barriers": [("      consumer_sync();\n      conv_bf16<0>", "      conv_bf16<0>"),
                         ("      consumer_sync();\n      conv_bf16<1>", "      conv_bf16<1>")],
    "no proxy fences": [("  fence_async_smem();\n}\n", "}\n")],
    "ring of 3 taps": [("constexpr int NSLOT = 6;", "constexpr int NSLOT = 3;")],
    "ring of 10 taps": [("constexpr int NSLOT = 6;", "constexpr int NSLOT = 10;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_mrf_stage: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = _build.BUILD_DIR / "ablate_mrf_stage"
    root.mkdir(parents=True, exist_ok=True)
    libs = _ablate.build("mrf_stage", VARIANTS, root)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    packed = [tuple((torch.randn(*shape, generator=gen) * scale).to(dev)
                    for shape, scale in (((3, k, 64, 64), 0.03), ((3, 1, 64), 0.1),
                                         ((3, k, 64, 64), 0.03), ((3, 1, 64), 0.1)))
              for k in KS]
    prep = mrf_stage.prepare_weights(packed, KS, DILS, torch.bfloat16)
    cases = []
    for B, T in SHAPES:
        x = torch.randn(B, T, 64, generator=gen).to(dev, torch.bfloat16)
        cases.append((B, T, x, mrf_stage.mrf_stack_plain(x, packed, KS, DILS).float()))
    for name, lib in libs.items():
        _ablate.bind(lib, "mrf_stage", {"mrf_stage_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_void_p])})
        row = []
        for B, T, x, ref in cases:
            def call():
                return mrf_stage.mrf_stack(x, None, KS, DILS, prep)
            err = (call().float() - ref).abs().max().item()
            reps = max(5, min(50, 2 ** 23 // (B * T)))
            row.append(f"B={B} T={T} {_ablate.device_ms(call, reps):.4f} ms (err {err:.1e})")
        print(f"{name:18s} " + "; ".join(row))
    _build._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
