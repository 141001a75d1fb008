"""Kernel D: one polyphase-folded HiFi-GAN MRF stage (3 branches × 3 units)
for the narrow stages, C < 64, at fold = 128 // C.

Replaces ``vispeech_tpu/ops/pallas/mrf_stage.py::mrf_stack_folded`` (body
``_mrf_folded_kernel``, conv ``_conv_offsets``) with
``csrc/mrf_stage_folded.cu``: the input read as [B, T/fold, fold·C], every
conv a folded conv by its tap offsets (``ops/folded_mrf.py``), windows of
192 folded frames with a halo of the deepest branch's folded receptive
radius, f32 state, conv operands in the I/O dtype (bf16 when serving) with
f32 accumulation, every folded frame outside [0, T/fold) re-zeroed after
each conv.  Compute-bound: 540 GFLOP of folded convs at fold 4 over 716 800
samples.  bf16 convs run on wgmma, three warpgroups taking a fixed 64-row
tile of the window each, the weights streamed tap by tap by bulk copies
from the core-matrix layout ``prepare_weights`` makes once (the serving
generator keeps it); f32 convs run on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.folded_mrf import BranchWeights, conv_folded, folded_units
from vispeech_tpu_torch.ops.kernels import _build, refuse_autograd

launches = 0

MAX_CF = 128   # folded channels the kernel computes
WIN = 192      # folded frames per block window (csrc/mrf_stage_folded.cu)
MAX_PAD = 8    # a bf16 conv's pads on each side: the slack rows beside the window
SCRATCH = 64 * 384   # f32 of branch sum a bf16 block keeps in global memory
# mrf_stage_folded_launch(x, w, bias, out, scratch, B, Tf, cf, n_br, n_unit, pads, halo,
# is_bf16, stream)
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def mrf_stack_folded_plain(x, packed: Sequence[BranchWeights], kernel_sizes, dilations,
                           fold: int):
    """x [B, T, C] → mean over branches of the folded ResBlock1 stacks,
    [B, T, C].  f32 state, every conv operand rounded to x's dtype, biases
    in f32, output cast to x's dtype: the kernel's arithmetic, summed in
    another order."""
    B, T, C = x.shape
    if T % fold:
        raise ValueError(f"T={T} not divisible by fold={fold}")
    dtype = x.dtype
    x0 = x.float().reshape(B, T // fold, fold * C).transpose(1, 2)
    acc = None
    for units in folded_units(packed, dilations, fold):
        state = x0
        for (wf1, bf1, p1), (wf2, bf2, p2) in units:
            h = F.leaky_relu(state, 0.1).to(dtype).float()
            y = conv_folded(h, wf1.to(dtype).float(), bf1, p1)
            h = F.leaky_relu(y, 0.1).to(dtype).float()
            state = state + conv_folded(h, wf2.to(dtype).float(), bf2, p2)
        acc = state if acc is None else acc + state
    return (acc / len(packed)).to(dtype).transpose(1, 2).reshape(B, T, C)


class FoldedWeights(NamedTuple):
    """Kernel D's operands, in the order the kernel reads them: every folded
    conv (branch by branch, unit by unit, the dilated conv before the plain
    one) and each of its taps, 128 × 128 in the I/O dtype: bf16 taps as
    [cout/8][cin/8][8 cout][8 cin] core matrices (32 KB each), f32 taps as
    [cin][cout]; the biases [128] f32 in the same order; the pads; the
    window halo."""

    w: torch.Tensor
    b: torch.Tensor
    pads: Tuple[int, ...]
    halo: int
    cf: int
    n_br: int
    n_unit: int
    dtype: torch.dtype


def _core_tiles(w: torch.Tensor) -> torch.Tensor:
    """[taps, cin, cout] → [taps, cout/8, cin/8, 8 cout, 8 cin]."""
    taps, cin, cout = w.shape
    return w.reshape(taps, cin // 8, 8, cout // 8, 8).permute(0, 3, 1, 4, 2)


def prepare_weights(packed: Sequence[BranchWeights], kernel_sizes, dilations, fold: int,
                    channels: int, dtype: torch.dtype) -> FoldedWeights:
    """Fold, pad to 128 channels and lay out the weights of a stage at
    ``channels`` for the kernel (about 150 small ops: a caller with fixed
    weights keeps the result, as the serving generator does)."""
    C = channels
    cf = fold * C
    if cf > MAX_CF or cf % 16 or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mrf_stage_folded kernel takes fold·C <= {MAX_CF} in steps of 16 "
                         f"in f32 or bf16; got fold={fold}, C={C}, {dtype}")
    n_br, n_unit = len(kernel_sizes), len(dilations[0])
    if (len(packed) != n_br or any(len(d) != n_unit for d in dilations) or n_br > 4
            or n_unit > 4):
        raise ValueError(f"mrf_stage_folded kernel takes <= 4 branches of <= 4 equal units; "
                         f"got {dilations}")
    for (w1, _, w2, _), k in zip(packed, kernel_sizes):
        if w1.shape != (n_unit, k, C, C) or w2.shape != w1.shape:
            raise ValueError(f"branch k={k} weights {tuple(w1.shape)}")
    # the bf16 kernel's wgmma reads each tap as core matrices
    bf16 = dtype == torch.bfloat16
    ws, bs, pads, halo = [], [], [], 0
    for units in folded_units(packed, dilations, fold):
        radius = [0, 0]
        for wf, bfold, (lo, hi) in (conv for unit in units for conv in unit):
            if bf16 and max(lo, hi) > MAX_PAD:
                raise ValueError(f"folded conv pads ({lo}, {hi}) exceed the bf16 kernel's "
                                 f"{MAX_PAD} slack rows")
            wf = F.pad(wf, (0, MAX_CF - cf, 0, MAX_CF - cf))
            ws.append((_core_tiles(wf) if bf16 else wf).reshape(-1))
            bs.append(F.pad(bfold, (0, MAX_CF - cf)))
            pads += [lo, hi]
            radius = [radius[0] + lo, radius[1] + hi]
        halo = max(halo, *radius)
    if WIN - 2 * halo < 16:
        raise ValueError(f"folded receptive radius {halo} exceeds the kernel's window")
    w = torch.cat(ws).to(dtype).contiguous()
    return FoldedWeights(w, torch.cat(bs).float().contiguous(), tuple(pads), halo, cf, n_br,
                         n_unit, dtype)


def launch_grid(batch: int, t_folded: int, halo: int) -> dict:
    """The grid of one launch: blocks (one per window of ``WIN`` folded
    frames of one batch item, each owning the ``tile`` in its middle)."""
    tile = WIN - 2 * halo
    return {"blocks": batch * -(-t_folded // tile), "tile": tile}


def mrf_stack_folded(x, packed: Optional[Sequence[BranchWeights]], kernel_sizes, dilations,
                     fold: int, prepared: Optional[FoldedWeights] = None):
    """Kernel D on a CUDA tensor; the plain version on a CPU tensor.  On the
    card ``prepared`` (from ``prepare_weights``, in x's dtype) stands in for
    ``packed``, which may then be None; without it the weights are folded
    and laid out at the call.  The plain version takes ``packed``."""
    if packed is None and (prepared is None or x.device.type == "cpu"):
        raise ValueError("mrf_stack_folded needs packed weights" + (
            " on a CPU tensor" if prepared is not None else " or prepared ones"))
    if x.device.type == "cpu":
        return mrf_stack_folded_plain(x, packed, kernel_sizes, dilations, fold)
    global launches
    refuse_autograd("mrf_stage_folded",
                    "ops/folded_mrf.py::mrf_stage_folded (Generator(fused=False))",
                    x, *[t for branch in packed or () for t in branch])
    B, T, C = x.shape
    if T % fold:
        raise ValueError(f"T={T} not divisible by fold={fold}")
    if prepared is None:
        prepared = prepare_weights(packed, kernel_sizes, dilations, fold, C, x.dtype)
    if prepared.cf != fold * C or prepared.dtype != x.dtype:
        raise ValueError(f"prepared weights for fold·C={prepared.cf} in {prepared.dtype}; "
                         f"got fold={fold}, C={C}, {x.dtype}")
    if prepared.w.device != x.device:
        raise ValueError("mrf_stage_folded inputs must share one device")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    bf16 = x.dtype == torch.bfloat16
    # the bf16 blocks' branch sums (f32), read back by the block that wrote them
    scratch = (torch.empty(launch_grid(B, T // fold, prepared.halo)["blocks"] * SCRATCH,
                           dtype=torch.float32, device=x.device) if bf16 else None)
    pads = (ctypes.c_int * len(prepared.pads))(*prepared.pads)
    fn = _build.function("mrf_stage_folded", "mrf_stage_folded_launch", ARGTYPES)
    status = fn(xc.data_ptr(), prepared.w.data_ptr(), prepared.b.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, T // fold, prepared.cf,
                prepared.n_br, prepared.n_unit, pads, prepared.halo, int(bf16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "mrf_stage_folded")
    launches += 1
    return out
