"""Kernel B: a whole dilation-1 WaveNet stack in one launch.

Replaces ``vispeech_tpu/ops/pallas/wn_stack.py::wn_stack`` (body
``_wn_kernel``, weights packed as ``pack_wn_weights`` does) with
``csrc/wn_stack.cu``.  A block owns a 48-frame window (a tile plus a halo of
L·(k//2) frames per side) and loops over the layers inside the block, so
the residual state and skip sum never leave the chip.  A deeper stack
(L·(k//2) > 16: the 16-layer posterior encoder) runs the same kernel's
per-layer mode, one launch per layer over 48-frame tiles with a k//2 halo,
the state and skip sum in global memory in f32 (L2-resident); each launch
counts.  Compute-bound: about 5 GFLOP per batch item at T = 1400, C = 192,
L = 4 and 19.8 GFLOP at L = 16; tensor cores in TF32 with the 3-pass hi/lo
split, which keeps f32 accuracy.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

launches = 0

MAX_SHALLOW_HALO = 16   # L·(k//2) the one-launch mode's 48-frame window takes


def fused_gate(x: torch.Tensor, cond, channels: int) -> torch.Tensor:
    """tanh(a[:C]) · sigmoid(a[C:]) of a = x + cond, over the last axis."""
    a = x + cond
    return torch.tanh(a[..., :channels]) * torch.sigmoid(a[..., channels:])


def wn_stack_plain(x, mask, cond, w_in, w_rs, b_rs, kernel_size: int):
    """x [B, T, C], mask [B, T, 1], cond [B, L, 2C] (input bias + speaker),
    w_in [L, k, C, 2C], w_rs [L, C, 2C] (last layer: its C outputs first,
    zeros after), b_rs [L, 1, 2C] → [B, T, C]."""
    C = x.shape[-1]
    L = w_in.shape[0]
    skip = torch.zeros_like(x)
    for l in range(L):
        a = F.conv1d(x.transpose(1, 2), w_in[l].permute(2, 1, 0),
                     padding=kernel_size // 2).transpose(1, 2)
        z = fused_gate(a, cond[:, l, None, :], C)
        rs = torch.matmul(z, w_rs[l]) + b_rs[l]
        if l < L - 1:
            x = (x + rs[..., :C]) * mask
            skip = skip + rs[..., C:]
    return (skip + rs[..., :C]) * mask


def wn_stack(x, mask, cond, w_in, w_rs, b_rs, kernel_size: int):
    """Kernel B on a CUDA tensor; the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return wn_stack_plain(x, mask, cond, w_in, w_rs, b_rs, kernel_size)
    global launches
    refuse_autograd("wn_stack", "wn_stack_train.wn_stack_train", x, cond, w_in, w_rs, b_rs)
    B, T, C = x.shape
    L = w_in.shape[0]
    expect = {"mask": (B, T, 1), "cond": (B, L, 2 * C),
              "w_in": (L, kernel_size, C, 2 * C), "w_rs": (L, C, 2 * C),
              "b_rs": (L, 1, 2 * C)}
    got = {"mask": mask, "cond": cond, "w_in": w_in, "w_rs": w_rs, "b_rs": b_rs}
    for name, shape in expect.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"wn_stack {name} {tuple(got[name].shape)} != {shape}")
    if C > 256 or C % 16 or kernel_size % 2 == 0:
        raise ValueError(f"wn_stack kernel takes C <= 256 in steps of 16 and odd k; "
                         f"got C={C}, k={kernel_size}")
    args = [t.contiguous().float() for t in (x, mask, cond, w_in, w_rs, b_rs)]
    for t in args:
        if t.device != x.device:
            raise ValueError("wn_stack inputs must share one device")
    out = torch.empty_like(args[0])
    lib = _build.load("wn_stack")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if L * (kernel_size // 2) <= MAX_SHALLOW_HALO:
        fn = lib.wn_stack_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        status = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, T, C, L, kernel_size,
                    stream)
        _build.check(status, "wn_stack")
        launches += 1
        return out.to(x.dtype)
    # per-layer mode: neighbouring blocks read a layer's input state, so
    # each layer writes the next state to the other of two buffers
    fn = lib.wn_stack_layer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    states = (torch.empty_like(out), torch.empty_like(out))
    skip = torch.empty_like(out)
    src = args[0]
    for layer in range(L):
        dst = out if layer == L - 1 else states[layer % 2]
        status = fn(src.data_ptr(), *(t.data_ptr() for t in args[1:]), dst.data_ptr(),
                    skip.data_ptr(), B, T, C, L, kernel_size, layer, stream)
        _build.check(status, "wn_stack")
        launches += 1
        src = dst
    return out.to(x.dtype)
