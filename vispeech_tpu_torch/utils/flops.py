"""FLOP and roofline accounting for MFU (``vispeech_tpu/utils/flops.py``).

* ``model_cost(fn, *args)``: the FLOPs and bytes of ``fn(*args)`` counted
  op by op as it runs.  Kernels A–F launch through ctypes, so PyTorch's
  dispatcher never sees their work, and a count on CUDA tensors would
  silently miss it.  So ``model_cost`` counts the plain path: it runs on
  CPU tensors, where every kernel wrapper runs its plain PyTorch version,
  and raises on a CUDA tensor.  The plain versions compute the same
  products as the kernels, so the count is the model's FLOPs, never
  inflated by a kernel's own recomputation, and the kernels' measured time
  on the card is the denominator.
* ``chip_peaks()``: the published dense peaks of the attached card
  (detected from ``torch.cuda.get_device_name``); None for a card not in
  the table and on the CPU.
* ``roofline_row(flops, bytes_hbm, ms)``: share of peak, arithmetic
  intensity, and compute- or bandwidth-bound at the card's ridge point,
  with the JAX function's arithmetic and keys.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# published dense peaks (NVIDIA's data sheet, SXM part, no sparsity, at the
# full 700 W power limit): FLOP/s by operand type, f32 outside the tensor
# cores; HBM bytes/s
_CHIP_PEAKS = {
    "h100_sxm": {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
                 "hbm_bytes": 3.35e12},
}


def detect_chip() -> Optional[str]:
    """'h100_sxm' from the first CUDA device's name; None for any other
    card and where there is no CUDA device."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0).upper()
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "h100_sxm"
    return None


def chip_peaks(chip: Optional[str] = None) -> Optional[Dict[str, float]]:
    chip = chip or detect_chip()
    return dict(_CHIP_PEAKS[chip], chip=chip) if chip in _CHIP_PEAKS else None


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs, each once an
    op; views move nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        if any(t.is_cuda for t in tensors):
            raise ValueError(
                "model_cost counts the plain path on CPU tensors: kernels A-F launch "
                "through ctypes, so on CUDA tensors their work would not be counted")
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


def model_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """{'flops', 'bytes'} of ``fn(*args, **kwargs)`` run once on CPU tensors.

    FLOPs: ``torch.utils.flop_counter``'s formulas, 2·M·K·N for a product
    (matmuls and convolutions, forward and backward; elementwise work is
    not counted, as XLA's count of the same graph is dominated by its dots
    and convolutions).  Bytes: every non-view op's tensor inputs and outputs
    once each, an upper bound on the memory traffic of the op-by-op path."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, _ByteCounter() as nbytes:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes": float(nbytes.bytes)}


def roofline_row(flops: float, bytes_hbm: float, ms: float, dtype: str = "bf16",
                 peaks: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Roofline classification of a measured stage.

    ``flops`` / ``bytes_hbm`` from ``model_cost``; ``ms`` the measured time
    on the card.  ``dtype`` picks the peak: 'bf16', else f32 (the CUDA
    cores)."""
    peaks = peaks or chip_peaks()
    row: Dict[str, Any] = {
        "gflops": round(flops / 1e9, 2),
        "hbm_gb": round(bytes_hbm / 1e9, 3),
        "ms": round(ms, 3),
        "achieved_tflops": round(flops / (ms * 1e-3) / 1e12, 2) if ms else None,
        # arithmetic intensity of the computation itself (flops per byte)
        "intensity": round(flops / max(bytes_hbm, 1.0), 1),
    }
    if peaks is None:
        return row
    peak_f = peaks["bf16_flops"] if dtype == "bf16" else peaks["f32_flops"]
    bw = peaks["hbm_bytes"]
    # ridge point: intensity below peak_f / bw cannot reach peak compute
    ridge = peak_f / bw
    t_compute = flops / peak_f
    t_memory = bytes_hbm / bw
    bound = "compute" if t_compute >= t_memory else "bandwidth"
    # share of the roofline at this intensity, and raw MFU against peak compute
    t_light = max(t_compute, t_memory)
    row.update({
        "mfu_pct": round(100.0 * flops / (ms * 1e-3) / peak_f, 2) if ms else None,
        "roofline_pct": round(100.0 * t_light / (ms * 1e-3), 2) if ms else None,
        "bound_by": bound,
        "ridge_intensity": round(ridge, 1),
        "speed_of_light_ms": round(t_light * 1e3, 3),
    })
    return row
