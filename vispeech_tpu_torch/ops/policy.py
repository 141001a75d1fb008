"""Serving policy: device, decode dtype and TF32, resolved once on the host
(the port's counterpart of ``vispeech_tpu/ops/policy.py``).

CUDA default: a bf16 decoder.  CPU: f32.  Kernels A, B and C are not a
policy choice: each wrapper launches its kernel on a CUDA tensor and runs
its plain version on a CPU tensor, so the device alone decides.  TF32 is
off: ``torch.backends.cudnn.allow_tf32`` is True in a fresh process, so a
plain f32 convolution would otherwise run in TF32 on the card;
``ServingPolicy.precision()`` turns both TF32 switches off for the duration
of a call and restores them after.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``None`` means CUDA; refuses CUDA when there is no GPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    decode_dtype: str = "float32"   # decoder activations: "float32" | "bfloat16"

    @property
    def torch_decode_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.decode_dtype]

    @contextlib.contextmanager
    def precision(self):
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


#: f32 decoder: the CPU default and the parity configuration.
FLOAT32 = ServingPolicy()
#: bf16 decoder: the CUDA default.
CUDA_SERVING = ServingPolicy(decode_dtype="bfloat16")


def default_serving_policy(device: torch.device) -> ServingPolicy:
    return CUDA_SERVING if device.type == "cuda" else FLOAT32
