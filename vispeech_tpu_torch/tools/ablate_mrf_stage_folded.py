"""Where kernel D's time goes: copies of ``csrc/mrf_stage_folded.cu`` with one
part of its bf16 path taken out, each built with nvcc and timed on the card
(device time with the calls queued ahead) at B = 1, C = 32, fold 4, k = 3,
7, 11, dilations 1, 3, 5: the 128- and 1400-frame buckets' C = 32 stage
(65 536 and 716 800 samples).

    python -m vispeech_tpu_torch.tools.ablate_mrf_stage_folded

A variant without a part computes garbage (its error against the plain
version is printed beside its time); the full kernel and the variants with
another ring depth are right.  The time a part costs is the full kernel's time less the
variant's, as far as the parts do not overlap.
"""

from __future__ import annotations

import sys

import torch

from vispeech_tpu_torch.ops.kernels import _build, mrf_stage_folded
from vispeech_tpu_torch.tools import _ablate

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3
C, FOLD = 32, 4
SHAPES = ((1, 128 * 512), (1, 1400 * 512))

VARIANTS = {
    "full": [],
    "no wgmma": [("    for (int ks = 0; ks < CF / 16; ++ks)\n      wgmma_m64n128k16(",
                  "    for (int ks = 0; ks < 0; ++ks)\n      wgmma_m64n128k16(")],
    # cut to a sixteenth: with none at all, nothing reads the products' sums
    # and the compiler may drop the wgmma themselves
    "no epilogue": [("  for (int j = 0; j < CF / 8; ++j) {\n    const int c = 8 * j + 2 * tq;\n"
                     "    const float2 bv",
                     "  for (int j = 0; j < 1; ++j) {\n    const int c = 8 * j + 2 * tq;\n"
                     "    const float2 bv")],
    # only the first NSLOT taps are copied, and nobody waits for them
    "no weight stream": [
        ("    mbar_wait(ring.full + slot, (it / NSLOT) & 1);\n", ""),
        ("    if (lead && it >= 1", "    if (false && lead && it >= 1")],
    "no conv barriers": [("  __syncthreads();   // every warpgroup's products", "  //"),
                         ("  __syncthreads();   // the next conv's products", "  //")],
    "ring of 2 taps": [("constexpr int NSLOT = 3;", "constexpr int NSLOT = 2;")],
    "ring of 4 taps": [("constexpr int NSLOT = 3;", "constexpr int NSLOT = 4;")],
    "ring of 5 taps": [("constexpr int NSLOT = 3;", "constexpr int NSLOT = 5;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_mrf_stage_folded: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = _build.BUILD_DIR / "ablate_mrf_stage_folded"
    root.mkdir(parents=True, exist_ok=True)
    libs = _ablate.build("mrf_stage_folded", VARIANTS, root)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    packed = [tuple((torch.randn(*shape, generator=gen) * scale).to(dev)
                    for shape, scale in (((3, k, C, C), 0.05), ((3, 1, C), 0.1),
                                         ((3, k, C, C), 0.05), ((3, 1, C), 0.1)))
              for k in KS]
    prep = mrf_stage_folded.prepare_weights(packed, KS, DILS, FOLD, C, torch.bfloat16)
    cases = []
    for B, T in SHAPES:
        x = torch.randn(B, T, C, generator=gen).to(dev, torch.bfloat16)
        cases.append((B, T, x, mrf_stage_folded.mrf_stack_folded_plain(
            x, packed, KS, DILS, FOLD).float()))
    for name, lib in libs.items():
        _ablate.bind(lib, "mrf_stage_folded",
                     {"mrf_stage_folded_launch": mrf_stage_folded.ARGTYPES})
        row = []
        for B, T, x, ref in cases:
            def call():
                return mrf_stage_folded.mrf_stack_folded(x, None, KS, DILS, FOLD, prep)
            err = (call().float() - ref).abs().max().item()
            reps = max(5, min(50, 2 ** 24 // (B * T)))
            row.append(f"B={B} T={T} {_ablate.device_ms(call, reps):.4f} ms (err {err:.1e})")
        print(f"{name:18s} " + "; ".join(row))
    _build._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
