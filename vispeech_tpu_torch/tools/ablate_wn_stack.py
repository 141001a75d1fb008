"""Where kernel B's time goes: copies of ``csrc/wn_stack.cu`` with one part
taken out, each built with nvcc and timed on the card (device time with the
calls queued ahead) at B = 1, C = 192, k = 5: T = 128 and 1400 with L = 4,
and the per-layer mode at T = 1400, L = 16.

    python -m vispeech_tpu_torch.tools.ablate_wn_stack

A variant without a part computes garbage (its error against the plain
version is printed beside its time); only the full kernel is right.  The
time a part costs is the full kernel's time less the variant's, as far as
the parts do not overlap.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from vispeech_tpu_torch.ops.kernels import _build, wn_stack
from vispeech_tpu_torch.tools import _ablate

WGMMA = ("        wgmma_n32(acc[s], al[ks], b_desc(hi));\n"
         "        wgmma_n32(acc[s], ah[ks], b_desc(hi + NSUB * 256));\n")
VARIANTS = {
    "full": [],
    "no wgmma": [(WGMMA + "        wgmma_n32(acc[s], ah[ks], b_desc(hi));\n", "")],
    "one pass (hi·hi)": [(WGMMA, "")],
    "no weight loads": [
        ("    mbar_wait(bars + it % NSTAGE, (it / NSTAGE) & 1);\n", ""),
        ("if (threadIdx.x == 0 && next < nchunks) {", "if (false) {"),
        ("      if (c < nchunks) {\n        const int slot", "      if (false) {\n        const int slot")],
    "no slice pulls": [("    pull_slices<C>(zs, lds, WIN, rank);\n", ""),
                       ("      pull_slices<C>(xs + pad * lds, lds, WIN, rank);\n", "")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_wn_stack: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    root = _build.BUILD_DIR / "ablate_wn_stack"
    root.mkdir(parents=True, exist_ok=True)
    libs = _ablate.build("wn_stack", VARIANTS, root)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    C, K = 192, 5
    cases = []
    for T, L in ((128, 4), (1400, 4), (1400, 16)):
        mask = (torch.arange(T, device=dev) < T - 50).float()[None, :, None]
        args = (rn(1, T, C), mask, rn(1, L, 2 * C, scale=0.1), rn(L, K, C, 2 * C, scale=0.03),
                rn(L, C, 2 * C, scale=0.05), rn(L, 1, 2 * C, scale=0.1))
        cases.append((T, L, args, wn_stack.prepare_weights(args[3], args[4])))
    for name, lib in libs.items():
        _ablate.bind(lib, "wn_stack", {
            symbol: [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            for symbol, n_ptr, n_int in (("wn_stack_launch", 7, 5),
                                         ("wn_stack_layer_launch", 8, 6))})
        row = []
        for T, L, args, prep in cases:
            def call():
                return wn_stack.wn_stack(*args[:3], None, None, args[5], K, prep)
            err = (call() - wn_stack.wn_stack_plain(*args, K)).abs().max().item()
            row.append(f"T={T} L={L} {_ablate.device_ms(call, 20):.4f} ms (err {err:.1e})")
        print(f"{name:18s} " + "; ".join(row))
    _build._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
