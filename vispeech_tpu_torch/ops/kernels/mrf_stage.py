"""Kernel C: one fused HiFi-GAN MRF stage (3 branches × 3 units) at C = 64.

Replaces ``vispeech_tpu/ops/pallas/mrf_stage.py::mrf_stack`` (body
``_mrf_kernel``, conv ``_conv_cm``, halo ``branch_halo``) with
``csrc/mrf_stage.cu``: tiles of 128 samples with a 64-sample halo, state in
shared memory, conv operands in the I/O dtype (bf16 when serving) with f32
accumulation, every position outside [0, T) re-zeroed after each conv.
Compute-bound: ~370 GFLOP per launch at a 1400-frame bucket; bf16 convs on
the tensor cores (mma.sync), f32 convs on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

launches = 0

# (w1 [U, k, C, C], b1 [U, 1, C], w2, b2): ResBlock1.packed() per branch
BranchWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mrf_stack_plain(x, packed: Sequence[BranchWeights], kernel_sizes, dilations):
    """x [B, T, C] → mean over branches of the ResBlock1 stacks, [B, T, C].

    Computes in f32 with every conv operand rounded to x's dtype and the
    biases in f32, then casts the output to x's dtype: the kernel's
    arithmetic, summed in another order."""
    dtype = x.dtype
    xf = x.float().transpose(1, 2)
    acc = None
    for (w1, b1, w2, b2), k, dils in zip(packed, kernel_sizes, dilations):
        state = xf
        for u, d in enumerate(dils):
            h = F.leaky_relu(state, 0.1).to(dtype).float()
            y = F.conv1d(h, w1[u].to(dtype).float().permute(2, 1, 0), b1[u, 0].float(),
                         padding=(k - 1) // 2 * d, dilation=d)
            h = F.leaky_relu(y, 0.1).to(dtype).float()
            y = F.conv1d(h, w2[u].to(dtype).float().permute(2, 1, 0), b2[u, 0].float(),
                         padding=(k - 1) // 2)
            state = state + y
        acc = state if acc is None else acc + state
    return (acc / len(packed)).to(dtype).transpose(1, 2)


def mrf_stack(x, packed: Sequence[BranchWeights], kernel_sizes, dilations):
    """Kernel C on a CUDA tensor; the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return mrf_stack_plain(x, packed, kernel_sizes, dilations)
    global launches
    refuse_autograd("mrf_stage", "the plain ResBlock1 stages (Generator(fused=False))",
                    x, *[t for branch in packed for t in branch])
    B, T, C = x.shape
    n_br, n_unit = len(kernel_sizes), len(dilations[0])
    if C != 64 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf_stage kernel takes C = 64 in f32 or bf16; got C={C}, "
                         f"{x.dtype}")
    if any(len(d) != n_unit for d in dilations) or n_br > 4 or n_unit > 4:
        raise ValueError(f"mrf_stage kernel takes <= 4 branches of <= 4 equal units; "
                         f"got {dilations}")
    for k, dils in zip(kernel_sizes, dilations):
        if sum((k - 1) // 2 * (d + 1) for d in dils) > 64:
            raise ValueError(f"branch k={k} dilations {dils}: receptive radius > 64")
    # the bf16 kernel feeds the tensor cores [tap][cout][cin] tiles
    bf16 = x.dtype == torch.bfloat16
    ws, bs = [], []
    for (w1, b1, w2, b2), k in zip(packed, kernel_sizes):
        if w1.shape != (n_unit, k, C, C) or w2.shape != w1.shape:
            raise ValueError(f"branch k={k} weights {tuple(w1.shape)}")
        for u in range(n_unit):
            for w in (w1[u], w2[u]):
                ws.append((w.transpose(1, 2) if bf16 else w).reshape(-1))
            bs += [b1[u].reshape(-1), b2[u].reshape(-1)]
    w = torch.cat(ws).to(x.dtype).contiguous()
    b = torch.cat(bs).float().contiguous()
    xc = x.contiguous()
    if w.device != x.device or b.device != x.device:
        raise ValueError("mrf_stage inputs must share one device")
    out = torch.empty_like(xc)
    ks = (ctypes.c_int * n_br)(*kernel_sizes)
    dl = (ctypes.c_int * (n_br * n_unit))(*[d for ds in dilations for d in ds])
    fn = _build.load("mrf_stage").mrf_stage_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    status = fn(xc.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, T, n_br,
                n_unit, ks, dl, int(bf16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "mrf_stage")
    launches += 1
    return out
