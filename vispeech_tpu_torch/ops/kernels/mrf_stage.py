"""Kernel C: one fused HiFi-GAN MRF stage (3 branches × 3 units) at C = 64.

Replaces ``vispeech_tpu/ops/pallas/mrf_stage.py::mrf_stack`` (body
``_mrf_kernel``, conv ``_conv_cm``, halo ``branch_halo``) with
``csrc/mrf_stage.cu``: a block owns ``TILE`` samples of one batch item and
a ``HALO`` on each side, the branch state in shared memory in f32, conv
operands in the I/O dtype (bf16 when serving) with f32 accumulation, every
position outside [0, T) re-zeroed after each conv.  Compute-bound: ~370
GFLOP per launch at a 1400-frame bucket.  bf16 convs run on wgmma, four
warpgroups taking a 64-row tile each, the weights streamed tap by tap by
bulk copies from the layout ``prepare_weights`` makes once (the serving
generator keeps it); f32 convs run on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

launches = 0

CHANNELS = 64   # the stage's width
TILE = 128      # samples a block owns (csrc/mrf_stage.cu)
HALO = 64       # samples of halo on each side: the largest receptive radius

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


class PreparedMRF(NamedTuple):
    """Kernel C's operands, laid out by ``prepare_weights`` in the order the
    kernel reads them: every conv (branch by branch, unit by unit, the
    dilated conv before the plain one) and each of its taps.  ``w`` in the
    I/O dtype: bf16 taps as [cout/8][cin/8][8 cout][8 cin] core matrices
    (8 KB each), f32 taps as [cin][cout]; ``b`` [convs, C] f32."""

    w: torch.Tensor
    b: torch.Tensor
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[Tuple[int, ...], ...]
    dtype: torch.dtype


def _check_stage(C: int, kernel_sizes, dilations, dtype) -> None:
    n_unit = len(dilations[0])
    if C != CHANNELS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf_stage kernel takes C = {CHANNELS} in f32 or bf16; got C={C}, "
                         f"{dtype}")
    if (len(dilations) != len(kernel_sizes) or any(len(d) != n_unit for d in dilations)
            or len(kernel_sizes) > 4 or n_unit > 4):
        raise ValueError(f"mrf_stage kernel takes <= 4 branches of <= 4 equal units; "
                         f"got {dilations}")
    for k, dils in zip(kernel_sizes, dilations):
        if k % 2 == 0 or sum((k - 1) // 2 * (d + 1) for d in dils) > HALO:
            raise ValueError(f"branch k={k} dilations {dils}: even k or receptive radius > "
                             f"{HALO}")


def _core_tiles(w: torch.Tensor) -> torch.Tensor:
    """[taps, cin, cout] → [taps, cout/8, cin/8, 8 cout, 8 cin]."""
    taps, cin, cout = w.shape
    return w.reshape(taps, cin // 8, 8, cout // 8, 8).permute(0, 3, 1, 4, 2)


def prepare_weights(packed: Sequence[BranchWeights], kernel_sizes, dilations,
                    dtype: torch.dtype) -> PreparedMRF:
    """ResBlock1.packed() of each branch → the kernel's operands in
    ``dtype`` (a few dozen small ops: a caller whose weights stay fixed
    keeps the result, as the serving generator does)."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    C = packed[0][0].shape[-1]
    _check_stage(C, kernel_sizes, dilations, dtype)
    n_unit = len(dilations[0])
    if len(packed) != len(kernel_sizes):
        raise ValueError(f"{len(packed)} branches of weights for kernel sizes {kernel_sizes}")
    ws, bs = [], []
    with torch.no_grad():
        for (w1, b1, w2, b2), k in zip(packed, kernel_sizes):
            if w1.shape != (n_unit, k, C, C) or w2.shape != w1.shape:
                raise ValueError(f"branch k={k} weights {tuple(w1.shape)}")
            for u in range(n_unit):
                for w in (w1[u], w2[u]):
                    w = w.to(dtype)
                    ws.append((_core_tiles(w) if dtype == torch.bfloat16 else w).reshape(-1))
                bs += [b1[u].reshape(-1), b2[u].reshape(-1)]
        return PreparedMRF(torch.cat(ws).contiguous(), torch.stack(bs).float().contiguous(),
                           kernel_sizes, dilations, dtype)


def launch_grid(batch: int, T: int) -> dict:
    """The grid of one launch: blocks (one per tile of ``TILE`` samples of
    one batch item) and the samples each block owns."""
    return {"blocks": batch * -(-T // TILE), "tile": TILE}


def mrf_stack(x, packed: Optional[Sequence[BranchWeights]], kernel_sizes, dilations,
              prepared: Optional[PreparedMRF] = None):
    """Kernel C on a CUDA tensor; the plain version on a CPU tensor.  On
    the card ``prepared`` (from ``prepare_weights``, in x's dtype) stands in
    for ``packed``, which may then be None; without it the weights are
    prepared at the call.  The plain version takes ``packed``."""
    if packed is None and (prepared is None or x.device.type == "cpu"):
        raise ValueError("mrf_stack needs packed weights" + (
            " on a CPU tensor" if prepared is not None else " or prepared ones"))
    if x.device.type == "cpu":
        return mrf_stack_plain(x, packed, kernel_sizes, dilations)
    global launches
    refuse_autograd("mrf_stage", "the plain ResBlock1 stages (Generator(fused=False))",
                    x, *[t for branch in packed or () for t in branch])
    B, T, C = x.shape
    _check_stage(C, tuple(kernel_sizes), tuple(tuple(d) for d in dilations), x.dtype)
    if prepared is None:
        prepared = prepare_weights(packed, kernel_sizes, dilations, x.dtype)
    if (prepared.dtype != x.dtype or prepared.kernel_sizes != tuple(kernel_sizes)
            or prepared.dilations != tuple(tuple(d) for d in dilations)):
        raise ValueError(f"mrf_stage weights prepared for k={prepared.kernel_sizes}, "
                         f"dilations {prepared.dilations} in {prepared.dtype}; got "
                         f"k={tuple(kernel_sizes)}, {x.dtype}")
    if prepared.w.device != x.device:
        raise ValueError("mrf_stage inputs must share one device")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    n_br, n_unit = len(kernel_sizes), len(dilations[0])
    ks = (ctypes.c_int * n_br)(*kernel_sizes)
    dl = (ctypes.c_int * (n_br * n_unit))(*[d for ds in dilations for d in ds])
    fn = _build.function("mrf_stage", "mrf_stage_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_void_p])
    status = fn(xc.data_ptr(), prepared.w.data_ptr(), prepared.b.data_ptr(), out.data_ptr(),
                B, T, n_br, n_unit, ks, dl, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "mrf_stage")
    launches += 1
    return out
