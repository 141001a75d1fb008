"""Where kernel F's bf16 backward spends its time: copies of
``csrc/rel_attention_train.cu`` with one part of the wgmma kernels
(namespace ``bwd16``) taken out or changed, each built with nvcc and timed
on the card at B = 12, H = 2, d = 96, T = 1024, rate 0.1 (``chip_smoke.py
--f-bwd``'s largest call), each kernel's device time by torch.profiler.

    python -m vispeech_tpu_torch.tools.ablate_rel_attention_train

The q and kv passes share one launch; "q pass only" and "kv pass only" give
each pass's time alone.  A variant without a part computes garbage (its
largest error against the full kernel's gradients, relative to their peak,
is printed beside its times); the others are right.
"""

from __future__ import annotations

import sys

import torch

from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import rel_attention_train as F
from vispeech_tpu_torch.tools import _ablate

T = 1024

_SS = "for (int k = 0; k < D / 16; ++k)\n      wgmma_n64("
_RS = "for (int kk = 0; kk < 4; ++kk)\n      wgmma_rs<D>("
VARIANTS = {
    "full": [],
    # the other pass's blocks return at once
    "q pass only": [("  else\n    kv_pass<D, DROP>(", "  else if (false)\n    kv_pass<D, DROP>(")],
    "kv pass only": [("  if (blockIdx.z == 0)\n    q_pass<D, DROP>(",
                      "  if (blockIdx.z == 0)\n    ;\n  else if (false)\n    q_pass<D, DROP>(")],
    "no wgmma": [(_SS, _SS.replace("k < D / 16", "k < 0")),
                 (_RS, _RS.replace("kk < 4", "kk < 0"))],
    "no keep hash": [("  return fmix32(rk ^ jk) >= thresh ? inv : 0.f;",
                      "  return (rk ^ jk) >= thresh ? inv : 0.f;")],
    "no exp": [("__expf(sc - lse_r[hr])", "(sc - lse_r[hr])"),
               ("__expf(sc - sm.st[buf][0][tl])", "(sc - sm.st[buf][0][tl])")],
    # every tile pair on the path without the band (wrong near the diagonal)
    "no band path": [("abs(kt - tile) <= 1", "false"), ("abs(qt - tile) <= 1", "false")],
    # every tile pair on the band's path
    "band everywhere": [("abs(kt - tile) <= 1", "true"), ("abs(qt - tile) <= 1", "true")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_rel_attention_train: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(_build._PKG.parent))
    import chip_smoke

    root = _build.BUILD_DIR / "ablate_rel_attention_train"
    root.mkdir(parents=True, exist_ok=True)
    libs = _ablate.build("rel_attention_train", VARIANTS, root)
    symbols = {"rel_attn_train_bwd_bf16": F._BF16_ARGS, "rel_attn_train_bwd_tile": []}
    full = None
    for name, lib in libs.items():
        _ablate.bind(lib, "rel_attention_train", symbols)
        r = chip_smoke.f_bwd_breakdown(torch, torch.device("cuda"), T)
        grads = r.pop("grads")
        if full is None:
            full = grads
        err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                  for a, b in zip(grads, full))
        ops = ", ".join(f"{k} {ms:.4f}" for k, (ms, _) in r["ops"].items() if "bwd16::" in k)
        print(f"{name:16s} device {r['device_ms']:.4f} ms (err {err:.1e}): {ops}", flush=True)
        _build._FUNCS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
