"""Where kernel E's bf16 forward and backward spend their time: copies of
``csrc/wn_stack_train.cu`` with one part of the wgmma kernels (namespaces
``wf`` and ``wg``) taken out or changed, each built with nvcc and timed on
the card at B = 12, T = 1024, L = 16, k = 5 (the posterior encoder's call),
each kernel's device time summed over the 16 layers by torch.profiler.

    python -m vispeech_tpu_torch.tools.ablate_wn_stack_train

Each variant prints the forward's time a call (at T = 1024, and at
T = 640, a frame bucket of the training step) and the backward's, each
with its largest error against the full kernel's outputs (out and xs;
the gradients), relative to their peak.  A variant without a part computes
garbage; the others are right.  The time a part costs is the full kernel's
time less the variant's, as far as the parts do not overlap.  The
backward's inputs come from the variant's forward.
"""

from __future__ import annotations

import sys

import torch

from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import wn_stack_train as E
from vispeech_tpu_torch.tools import _ablate

B, T, L, K, C = 12, 1024, 16, 5, 192

_WGRAD_MMA = "    for (int ks = 0; ks < 4; ++ks)\n      wgmma_n128_mn("
_ACT_MMA_X = "      for (int ks = 0; ks < 4; ++ks)\n        wgmma_n128("
_ACT_MMA_D = "      for (int ks = 0; ks < 8; ++ks)\n        wgmma_n64("
_FWD_MMA = "      for (int k16 = 0; k16 < {n}; ++k16)\n        wgmma_n{w}(acc, smem_desc({a}"
VARIANTS = {
    "full": [],
    "fwd: no wgmma": [(_FWD_MMA.format(n=n, w=w, a=a), _FWD_MMA.format(n=0, w=w, a=a))
                      for n, w, a in ((4, 128, "xa"), (2, 192, "za"))],
    # a block of one warpgroup (64 rows), two blocks an SM
    "fwd: 64-row blocks": [("constexpr int FWD_WGS = 2;", "constexpr int FWD_WGS = 1;")],
    # z from tanhf and expf, not the special function unit's tanh
    "fwd: exact tanh": [(f"tanh_approx(acc[{a}] + ct.{c})", f"tanhf(acc[{a}] + ct.{c})")
                        for a, c in (("e", "x"), ("e + 1", "y"))]
    + [(f"fmaf(0.5f, tanh_approx(0.5f * (acc[{a} + e] + cs.{c})), 0.5f)",
        f"(1.f / (1.f + expf(-(acc[{a} + e] + cs.{c}))))") for a, c in (("32", "x"), ("33", "y"))],
    # the epilogue's loads and stores, not its copies
    "fwd: no epilogue": [("      for (int hr = 0; hr < 2; ++hr)\n#pragma unroll\n"
                          "        for (int j = 0; j < EQ / 8; ++j) {",
                          "      for (int hr = 0; hr < 0; ++hr)\n#pragma unroll\n"
                          "        for (int j = 0; j < EQ / 8; ++j) {")],
    # each slot is marked full without a copy into it
    "fwd: no weight stream": [
        (r'"@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"',
         r'"@p mbarrier.arrive.shared::cta.b64 _, [%3];\n"'),
        (r'"@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "'
         '\n      ' r'"[%3];\n}\n"', r'"}\n"')],
    "wgrad: no wgmma": [(_WGRAD_MMA, _WGRAD_MMA.replace("ks < 4", "ks < 0"))],
    # nobody waits for the stages, and nothing copies them
    "wgrad: no loads": [("    mbar_wait(full + st, (k / nst) & 1);\n", ""),
                        ("      const size_t po = bb * pb", "      cp_arrive(full + st);\n"
                         "      continue;\n      const size_t po = bb * pb")],
    "wgrad: 4 stages": [("constexpr int WG_STAGES = 8;", "constexpr int WG_STAGES = 4;")],
    "act: no wgmma": [(_ACT_MMA_X, _ACT_MMA_X.replace("ks < 4", "ks < 0")),
                      (_ACT_MMA_D, _ACT_MMA_D.replace("ks < 8", "ks < 0"))],
    "act: no global loads": [("      if (r < TR + 2 * pad && t >= 0 && t < T)\n",
                              "      if (false)\n"),
                             ("      if (t < T && !zero)\n", "      if (false)\n")],
    # an eighth of the gate's epilogue: with none, nothing reads the sums
    "act: 1/8 epilogue": [("    for (int i = 0; i < 8; ++i) {\n      const int c = 64 * jc",
                           "    for (int i = 0; i < 1; ++i) {\n      const int c = 64 * jc")],
    # the producers copy no weights, and nobody waits for them
    "act: no weight stream": [
        ("        mbar_expect(full + slot, ACT_SLOT * 2);\n"
         "        bulk_copy(slots + slot * ACT_SLOT, w + (size_t)i * ACT_SLOT, ACT_SLOT * 2, "
         "full + slot);\n", ""),
        ("      mbar_wait(full + slot, (it / ACT_NS) & 1);\n      const __nv_bfloat16* a = xw",
         "      const __nv_bfloat16* a = xw"),
        ("      mbar_wait(full + slot, (it / ACT_NS) & 1);\n      const __nv_bfloat16* a = ds",
         "      const __nv_bfloat16* a = ds")],
    "dx: no weight stream": [
        ("        mbar_expect(full + slot, DX_SLOT * 2);\n"
         "        bulk_copy(slots + slot * DX_SLOT, w + (size_t)i * DX_SLOT, DX_SLOT * 2, "
         "full + slot);\n", ""),
        ("    mbar_wait(full + slot, (q / DX_NS) & 1);\n", "")],
    "dx: no wgmma": [("    for (int ks = 0; ks < 4; ++ks)\n      wgmma_n192(",
                      "    for (int ks = 0; ks < 0; ++ks)\n      wgmma_n192(")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_wn_stack_train: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(_build._PKG.parent))
    import chip_smoke

    root = _build.BUILD_DIR / "ablate_wn_stack_train"
    root.mkdir(parents=True, exist_ok=True)
    libs = _ablate.build("wn_stack_train", VARIANTS, root)
    symbols = {"wn_train_bf16_forward": E.FWD_ARGTYPES,
               "wn_train_bf16_backward": E.BF16_ARGTYPES}
    dev = torch.device("cuda")
    full = {}
    for name, lib in libs.items():
        _ablate.bind(lib, "wn_stack_train", symbols)
        line = []
        for part, run, ns in (("fwd", chip_smoke.e_fwd_breakdown, "wf::"),
                              ("fwd T=640", lambda *a: chip_smoke.e_fwd_breakdown(*a, T=640),
                               "wf::"),
                              ("bwd", chip_smoke.e_bwd_breakdown, "wg::")):
            r = run(torch, dev)
            outs = r.pop("grads")
            full.setdefault(part, outs)
            err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                      for a, b in zip(outs, full[part]))
            ops = ", ".join(f"{k} {ms:.4f}" for k, (ms, _) in r["ops"].items() if ns in k)
            line.append(f"{part} {r['ms']:.4f} ms a call (err {err:.1e}): {ops}")
        print(f"{name:22s} " + "; ".join(line), flush=True)
        _build._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
