"""Kernel B: a whole dilation-1 WaveNet stack in one launch.

Replaces ``vispeech_tpu/ops/pallas/wn_stack.py::wn_stack`` (body
``_wn_kernel``, weights packed as ``pack_wn_weights`` does) with
``csrc/wn_stack.cu``.  A cluster of ``NCL`` CTAs owns a window of 64 frames
(a tile plus a halo of L·(k//2) frames per side) and splits its channels:
each CTA, one warpgroup, computes a quarter of the gate and res/skip columns
with wgmma and hands its slice of z and of the new state to the others
through distributed shared memory, so the residual state and skip sum never
leave the chip.  A deeper stack (L·(k//2) > 16: the 16-layer posterior
encoder) runs the same kernel's per-layer mode, one cluster launch per layer
over 64-frame tiles with a k//2 halo, the state and skip sum in global
memory in f32 (L2-resident); each launch counts.  Compute-bound: about
5 GFLOP per batch item at T = 1400, C = 192, L = 4 and 19.8 GFLOP at
L = 16; tensor cores in TF32 with the 3-pass hi/lo split, which keeps f32
accuracy.

The weights' hi/lo split and layout (``prepare_weights``) is done once by a
caller whose weights stay fixed (``ops/wavenet.py::WN`` keeps it while its
frozen weights are unchanged) or at each call otherwise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

launches = 0

MAX_SHALLOW_HALO = 16   # L·(k//2) the one-launch mode's window takes
NCL = 4                 # CTAs per cluster (csrc/wn_stack.cu)
WIN = 64                # window frames: wgmma's 64 rows

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


def expected_launches(n_layers: int, kernel_size: int) -> int:
    """Launches one stack makes: 1, or one per layer in the per-layer mode."""
    return 1 if n_layers * (kernel_size // 2) <= MAX_SHALLOW_HALO else n_layers


def launch_grid(batch: int, T: int, n_layers: int, kernel_size: int) -> dict:
    """The grid of each launch: CTAs, cluster size and window frames."""
    halo = n_layers * (kernel_size // 2)
    tile = WIN - (2 * halo if halo <= MAX_SHALLOW_HALO else 0)
    return {"ctas": NCL * batch * -(-T // tile), "cluster": NCL, "window": WIN}


def split_tf32(w: torch.Tensor):
    """(hi, lo): w rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``) and the rest rounded the same way;
    w − hi − lo is within 2^-22·|w|."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(w.float())
    return hi, rna(w.float() - hi)


def _tiles(w: torch.Tensor) -> torch.Tensor:
    """[L, Kd, 2C] → [L, NCL, Kd/8, 2, C/64, 4, 2, 8, 4]: per CTA r (its C/NCL
    columns of each half) and k-step of 8, hi then lo, per 16-column group
    s of the slice its 4 n8 tiles (two of the first half, the same two of
    the second), each as wgmma's K-major core matrices: 2 along k of 8
    columns × 4 k."""
    L, Kd, C2 = w.shape
    nsub = C2 // 2 // NCL // 16
    # column half·C + r·C/NCL + 16·s + 8·jj + n
    w = w.reshape(L, Kd, 2, NCL, nsub, 2, 8).permute(0, 3, 1, 4, 2, 5, 6)
    hi, lo = split_tf32(w)       # [L, r, Kd, s, half, jj, n]

    def core(t):   # [L, r, step, kg, e, s, half, jj, n] → [L, r, step, s, half, jj, kg, n, e]
        t = t.reshape(L, NCL, Kd // 8, 2, 4, nsub, 2, 2, 8)
        return t.permute(0, 1, 2, 5, 6, 7, 3, 8, 4).reshape(L, NCL, Kd // 8, nsub, 4, 2, 8, 4)

    return torch.stack([core(hi), core(lo)], dim=3)


class PreparedWN(NamedTuple):
    """Kernel B's weight operands: W_in and W_rs split and laid out by
    ``prepare_weights``, with the shape they came from."""

    w_in: torch.Tensor
    w_rs: torch.Tensor
    n_layers: int
    kernel_size: int
    channels: int


def check_shape(channels: int, kernel_size: int) -> None:
    if channels > 256 or channels % (16 * NCL) or kernel_size % 2 == 0:
        raise ValueError(f"wn_stack kernel takes C <= 256 in steps of {16 * NCL} (a cluster of "
                         f"{NCL} CTAs splits the channels) and odd k; "
                         f"got C={channels}, k={kernel_size}")


def prepare_weights(w_in: torch.Tensor, w_rs: torch.Tensor) -> PreparedWN:
    """w_in [L, k, C, 2C], w_rs [L, C, 2C] → the kernel's operands: each
    weight split into TF32 hi and lo and laid out per CTA column slice in
    wgmma's core-matrix order (a few ops over 7 MB at C = 192, L = 4: a
    caller with fixed weights keeps the result)."""
    L, k, C, C2 = w_in.shape
    check_shape(C, k)
    if C2 != 2 * C or tuple(w_rs.shape) != (L, C, 2 * C):
        raise ValueError(f"wn_stack weights w_in {tuple(w_in.shape)}, w_rs {tuple(w_rs.shape)}")
    with torch.no_grad():
        return PreparedWN(_tiles(w_in.reshape(L, k * C, C2)).contiguous(),
                          _tiles(w_rs).contiguous(), L, k, C)


def wn_stack(x, mask, cond, w_in, w_rs, b_rs, kernel_size: int,
             prepared: Optional[PreparedWN] = None):
    """Kernel B on a CUDA tensor; the plain version on a CPU tensor.
    ``prepared`` (from ``prepare_weights``) stands for w_in and w_rs on
    the card, which may then be None."""
    if x.device.type == "cpu":
        return wn_stack_plain(x, mask, cond, w_in, w_rs, b_rs, kernel_size)
    global launches
    refuse_autograd("wn_stack", "wn_stack_train.wn_stack_train", x, cond, w_in, w_rs, b_rs)
    B, T, C = x.shape
    check_shape(C, kernel_size)
    if prepared is None:
        prepared = prepare_weights(w_in, w_rs)
    L = prepared.n_layers
    if (prepared.channels, prepared.kernel_size) != (C, kernel_size):
        raise ValueError(f"wn_stack prepared for C={prepared.channels}, k={prepared.kernel_size};"
                         f" got C={C}, k={kernel_size}")
    expect = {"mask": (B, T, 1), "cond": (B, L, 2 * C), "b_rs": (L, 1, 2 * C)}
    got = {"mask": mask, "cond": cond, "b_rs": b_rs}
    for name, shape in expect.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"wn_stack {name} {tuple(got[name].shape)} != {shape}")
    args = [t.contiguous().float() for t in (x, mask, cond)]
    args += [prepared.w_in, prepared.w_rs, b_rs.contiguous().float()]
    for t in args:
        if t.device != x.device:
            raise ValueError("wn_stack inputs must share one device")
    out = torch.empty_like(args[0])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if expected_launches(L, kernel_size) == 1:
        fn = _build.function("wn_stack", "wn_stack_launch",
                             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        status = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, T, C, L, kernel_size,
                    stream)
        _build.check(status, "wn_stack")
        launches += 1
        return out.to(x.dtype)
    # per-layer mode: neighbouring clusters read a layer's input state, so
    # each layer writes the next state to the other of two buffers
    fn = _build.function("wn_stack", "wn_stack_layer_launch",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
