"""Kernel E: the trainable dilation-1 WaveNet stack, forward and backward.

Replaces ``vispeech_tpu/ops/pallas/wn_stack_train.py::wn_stack_train``
(custom VJP; bodies ``_fwd_kernel`` and ``_bwd_kernel``) with
``csrc/wn_stack_train.cu``.  The forward is kernel B's math and also keeps
every layer's input ``xs[b, l]`` for the backward.  The backward walks the
layers in reverse, rematerializes the gate from ``xs`` and emits dx, dcond
and the weight gradients; weight and bias gradients are per-tile partial
sums reduced here in a fixed order, so a run is reproducible bit for bit.

The CUDA kernels run one layer per launch with a halo of k//2 frames (no
recomputed L·(k//2) halo as kernel B has, so any depth works).  With f32
operands the forward and the backward run every product on the tensor
cores as 3-pass mma.sync TF32, one library call a layer.  With bf16
operands both run on wgmma (k <= 5), one library call running every layer:
the forward per layer the gate and the two halves of the res/skip product,
its weights laid out once a call by ``prepare_fwd_weights``; the backward
per layer the gate and dz, dx, and the weight gradients, over bf16
intermediates in a tiled layout (``to_tiled``), its weights laid out once a
call by ``prepare_bwd_weights``.  ``wn_stack_train_tiled_fwd`` and
``wn_stack_train_tiled_bwd`` are their data flows in plain PyTorch, which
the CPU tests hold to the plain forward and backward.

``bf16_compute``: every matmul operand is rounded to bf16, every
accumulator, carry, gate and column sum stays f32, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vispeech_tpu_torch.ops.kernels import _build

fwd_launches = 0
bwd_launches = 0


def _r(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matmul operand: rounded to bf16 under ``bf16_compute``, f32 else."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _conv(x, w, pad: int):
    """x [B, T, C] correlated with w [k, C, N] (SAME, zero padding) → [B, T, N]."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=pad).transpose(1, 2)


def wn_stack_train_plain_fwd(x, mask, cond, w_in, w_rs, b_rs, kernel_size: int,
                             bf16_compute: bool = False):
    """All f32.  x [B, T, C], mask [B, T, 1], cond [B, L, 2C], w_in
    [L, k, C, 2C], w_rs [L, C, 2C], b_rs [L, 1, 2C] → (out [B, T, C],
    xs [B, L, T, C] the layer inputs)."""
    C = x.shape[-1]
    L = w_in.shape[0]
    pad = kernel_size // 2
    skip = torch.zeros_like(x)
    xs = []
    for l in range(L):
        xs.append(x)
        a = cond[:, l, None, :] + _conv(_r(x, bf16_compute), _r(w_in[l], bf16_compute), pad)
        z = torch.tanh(a[..., :C]) * torch.sigmoid(a[..., C:])
        rs = torch.matmul(_r(z, bf16_compute), _r(w_rs[l], bf16_compute)) + b_rs[l]
        if l < L - 1:
            x = (x + rs[..., :C]) * mask
            skip = skip + rs[..., C:]
    return (skip + rs[..., :C]) * mask, torch.stack(xs, dim=1)


def wn_stack_train_plain_bwd(dout, xs, mask, cond, w_in, w_rs, kernel_size: int,
                             bf16_compute: bool = False):
    """``_bwd_kernel``'s formulas (``wn_stack_train.py:133-191``), written out.
    → (dx, dcond [B, L, 2C], dw_in, dw_rs, db_rs [L, 1, 2C]), all f32."""
    B, L, T, C = xs.shape
    pad = kernel_size // 2
    r = lambda t: _r(t, bf16_compute)  # noqa: E731
    g_out = dout * mask
    dx = None
    dcond, dw_in, dw_rs, db_rs = [None] * L, [None] * L, [None] * L, [None] * L
    for l in reversed(range(L)):
        x_l = xs[:, l]
        a = cond[:, l, None, :] + _conv(r(x_l), r(w_in[l]), pad)
        t_ = torch.tanh(a[..., :C])
        s_ = torch.sigmoid(a[..., C:])
        z = t_ * s_
        last = l == L - 1
        dres = g_out if last else dx * mask
        d_rs = torch.cat([dres, torch.zeros_like(g_out) if last else g_out], dim=-1)
        dw_rs[l] = torch.einsum("btc,btn->cn", r(z), r(d_rs))
        db_rs[l] = d_rs.sum(dim=(0, 1))[None]
        dz = torch.matmul(r(d_rs), r(w_rs[l]).t())
        dacts = torch.cat([dz * s_ * (1.0 - t_ * t_), dz * t_ * s_ * (1.0 - s_)], dim=-1)
        dcond[l] = dacts.sum(dim=1)
        xp = F.pad(r(x_l), (0, 0, pad, pad))
        dp = F.pad(r(dacts), (0, 0, pad, pad))
        dw_l, dx_conv = [], torch.zeros_like(x_l)
        for tap in range(kernel_size):
            dw_l.append(torch.einsum("btc,btn->cn", xp[:, tap:tap + T], r(dacts)))
            # acts[t] reads x[t + tap − pad], so dx[t] gets dacts[t − tap + pad]
            start = 2 * pad - tap
            dx_conv = dx_conv + torch.matmul(dp[:, start:start + T], r(w_in[l, tap]).t())
        dw_in[l] = torch.stack(dw_l)
        dx = dx_conv if last else dx_conv + dres
    return (dx, torch.stack(dcond, dim=1), torch.stack(dw_in), torch.stack(dw_rs),
            torch.stack(db_rs))


_SUPPORTED_C = 192
WGRAD_SPLITS = 4   # row splits of each f32 weight-gradient product (fixed: deterministic sums)

# The bf16 backward on wgmma (csrc/wn_stack_train.cu, namespace wg)
TILE_ROWS = 128          # rows a bwd_act or bwd_dx block owns (wg::TR)
HALO_ROWS = 8            # zero rows on each side of a tiled intermediate (wg::HP)
WGRAD_ROWS = 64          # rows a weight-gradient stage carries (wg::RK)
WGRAD_SPLITS_BF16 = 7    # row splits of each bf16 weight-gradient product (wg::WGRAD_SPLITS)
WGRAD_GROUP = 3          # products a weight-gradient block takes (wg::TAPG)
BF16_MAX_K = 5           # the bf16 kernels' largest kernel size (wg::PAD = 2)
ACT_BLOCK = 8192         # bf16 per prepared k block of the gate (wg::ACT_SLOT)
DX_BLOCK = 64 * _SUPPORTED_C   # ... of bwd_dx (wg::DX_SLOT)
RS_BLOCK = 32 * _SUPPORTED_C   # ... of the forward's res/skip halves (wf::RS_BLOCK)
FWD_ROWS = 128                 # rows a block of the bf16 forward owns (wf::FWD_WGS warpgroups)


def tiled_rows(T: int):
    """→ (Tr, Tp): T rounded up to whole ``TILE_ROWS`` tiles, and the rows a
    tiled intermediate holds per chunk, with ``HALO_ROWS`` zeros each side."""
    Tr = -(-T // TILE_ROWS) * TILE_ROWS
    return Tr, Tr + 2 * HALO_ROWS


def to_tiled(x: torch.Tensor, Tp: int) -> torch.Tensor:
    """[B, T, ch] → the kernels' tiled layout [B, ch/8, Tp, 8]: chunk j of
    batch item b holds channels [8j, 8j + 8) of rows t at HALO_ROWS + t, and
    zeros elsewhere."""
    B, T, ch = x.shape
    out = x.new_zeros(B, ch // 8, Tp, 8)
    out[:, :, HALO_ROWS:HALO_ROWS + T] = x.reshape(B, T, ch // 8, 8).transpose(1, 2)
    return out


def from_tiled(x: torch.Tensor, T: int, shift: int = 0) -> torch.Tensor:
    """The tiled layout back to [B, T, ch], rows t + shift (zeros outside)."""
    B, n, _, _ = x.shape
    rows = x[:, :, HALO_ROWS + shift:HALO_ROWS + shift + T]
    return rows.transpose(1, 2).reshape(B, T, 8 * n)


class BwdWeights(NamedTuple):
    """The bf16 backward's weights, laid out by ``prepare_bwd_weights`` in
    the order its kernels stream them, as wgmma's K-major core matrices
    ([n/8][k/8][8 n][8 k] per k block).  ``act`` [L, 3, (3k + 3)·ACT_BLOCK]:
    per 64-column chunk jc of C, for each tap and each 64-deep k block the
    W_in columns [64jc, +64) (tanh) and [C + 64jc, +64) (sigmoid), then
    W_rs[:, 64jc:+64]ᵀ in three 128-deep k blocks.  ``dx`` [L, k, 6·DX_BLOCK]:
    W_in[tap]ᵀ in six 64-deep k blocks over 2C."""

    act: torch.Tensor
    dx: torch.Tensor


def _gate_blocks(wi: torch.Tensor) -> torch.Tensor:
    """W_in [L, k, C, 2C] → the gate's k blocks [L, 3, 3k·ACT_BLOCK]: per
    64-column chunk jc, for each tap and each 64-deep k block, the columns
    [64jc, +64) (tanh) and [C + 64jc, +64) (sigmoid)."""
    L, k, C, _ = wi.shape
    # [L, k, C, 2 halves, 3 jc, 64] → [L, jc, k, kb, n/8, k/8, 8 n, 8 k]
    a = wi.reshape(L, k, C, 2, 3, 64).permute(0, 4, 1, 2, 3, 5)
    a = a.reshape(L, 3, k, 3, 8, 8, 16, 8).permute(0, 1, 2, 3, 6, 4, 7, 5)
    return a.reshape(L, 3, 3 * k * ACT_BLOCK)


def prepare_fwd_weights(w_in: torch.Tensor, w_rs: torch.Tensor) -> torch.Tensor:
    """w_in [L, k, C, 2C], w_rs [L, C, 2C] → the bf16 forward's weights
    [L, 9k·ACT_BLOCK + 12·RS_BLOCK] in bf16, made once per forward call, in
    the order its kernel streams them as wgmma's K-major core matrices
    ([n/8][k/8][8 n][8 k] per k block): per layer the gate's k blocks as
    ``prepare_bwd_weights`` lays them out for bwd_act, then W_rs as it is
    (K = C, N = 2C) in two halves of C columns (residual, skip), each in
    six 32-deep k blocks."""
    L, k, C, C2 = w_in.shape
    with torch.no_grad():
        gate = _gate_blocks(w_in.detach().to(torch.bfloat16)).reshape(L, -1)
        # W_rs: [L, kb, k/8, 8 k, half, n/8, 8 n] → [L, half, kb, n/8, k/8, 8 n, 8 k]
        r = w_rs.detach().to(torch.bfloat16).reshape(L, 6, 4, 8, 2, C // 8, 8)
        r = r.permute(0, 4, 1, 5, 2, 6, 3).reshape(L, 12 * RS_BLOCK)
        return torch.cat([gate, r], dim=1)


def prepare_bwd_weights(w_in: torch.Tensor, w_rs: torch.Tensor) -> BwdWeights:
    """w_in [L, k, C, 2C], w_rs [L, C, 2C] → ``BwdWeights`` in bf16, made
    once per backward call (the weights change at every optimizer step)."""
    L, k, C, C2 = w_in.shape
    with torch.no_grad():
        wi = w_in.detach().to(torch.bfloat16)
        a = _gate_blocks(wi)
        # act, W_rsᵀ: B[j][c] = W_rs[c][j]: [L, jc, n/8, 8 n, kb, k/8, 8 k]
        #   → [L, jc, kb, n/8, k/8, 8 n, 8 k]
        r = w_rs.detach().to(torch.bfloat16).reshape(L, 3, 8, 8, 3, 16, 8)
        r = r.permute(0, 1, 4, 2, 5, 3, 6).reshape(L, 3, 3 * ACT_BLOCK)
        # dx, W_in[tap]ᵀ: B[j][c] = W_in[tap][c][j]: [L, k, n/8, 8 n, kb, k/8, 8 k]
        #   → [L, k, kb, n/8, k/8, 8 n, 8 k]
        d = wi.reshape(L, k, C // 8, 8, C2 // 64, 8, 8).permute(0, 1, 4, 2, 5, 3, 6)
        return BwdWeights(torch.cat([a, r], dim=2).contiguous(),
                          d.reshape(L, k, (C2 // 64) * DX_BLOCK).contiguous())


def bwd_grid(B: int, T: int, kernel_size: int) -> dict:
    """The bf16 backward's launches for one layer: bwd_act, bwd_dx and the
    weight gradients (blocks, threads), and the (batch item, WGRAD_ROWS)
    items each weight-gradient split sums over.  The k + 1 products (one a
    tap, and dW_rs) go WGRAD_GROUP to a block."""
    Tr, _ = tiled_rows(T)
    items = B * Tr // WGRAD_ROWS
    splits = [(s * items // WGRAD_SPLITS_BF16, (s + 1) * items // WGRAD_SPLITS_BF16)
              for s in range(WGRAD_SPLITS_BF16)]
    groups = -(-(kernel_size + 1) // WGRAD_GROUP)
    return {"act": ((Tr // TILE_ROWS, B), 384), "dx": ((Tr // TILE_ROWS, B), 288),
            "wgrad": ((3 * groups, 3, WGRAD_SPLITS_BF16), WGRAD_GROUP * 128 + 128),
            "splits": splits}


def fwd_grid(B: int, T: int) -> tuple:
    """The bf16 forward's launch for one layer: (blocks, threads), a block
    of FWD_ROWS rows of one batch item, 64 a warpgroup."""
    return (-(-T // FWD_ROWS), B), 2 * FWD_ROWS


def _act_block(block: torch.Tensor, n: int) -> torch.Tensor:
    """One prepared k block ([n/8][k/8][8 n][8 k]) as its [k, n] matrix."""
    return block.reshape(n // 8, -1, 8, 8).permute(1, 3, 0, 2).reshape(-1, n)


def wn_stack_train_tiled_fwd(x, mask, cond, w: torch.Tensor, b_rs, kernel_size: int):
    """The bf16 forward as its wgmma kernel computes it, in plain PyTorch:
    each layer's x_l window in bf16 over rows up to whole 128-row blocks
    (zeros outside [0, T)), the gate chunk by chunk from ``w``'s
    (``prepare_fwd_weights``) k blocks, z in bf16, rs in its residual and
    skip halves, and the epilogue in f32 with x_l re-read unrounded.  Shapes
    as ``wn_stack_train_plain_fwd``; equals it with ``bf16_compute`` up to
    f32 summation order; the CPU tests hold the layout to it."""
    B, T, C = x.shape
    L, k, pad = w.shape[0], kernel_size, kernel_size // 2
    Tr, _ = tiled_rows(T)
    n_gate = 9 * k * ACT_BLOCK
    rows = lambda t: F.pad(t, (0, 0, 0, Tr - T))  # noqa: E731  [B, T, ·] → [B, Tr, ·]
    m = rows(mask)
    xl, xs = rows(x), [x]
    skip = torch.zeros(B, Tr, C)
    for l in range(L):
        gate = w[l, :n_gate].reshape(3, 3 * k, ACT_BLOCK).float()
        halves = w[l, n_gate:].reshape(2, 6, RS_BLOCK).float()
        xw = F.pad(xl[:, :T].to(torch.bfloat16).float(), (0, 0, pad, Tr - T + pad))
        z = torch.zeros(B, Tr, C)
        for jc in range(3):
            a = torch.zeros(B, Tr, 128)
            for tap in range(k):
                for kb in range(3):
                    a = a + xw[:, tap:tap + Tr, 64 * kb:64 * kb + 64] @ _act_block(
                        gate[jc, 3 * tap + kb], 128)
            cols = slice(64 * jc, 64 * jc + 64)
            th = torch.tanh(a[..., :64] + cond[:, l, None, cols])
            sg = torch.sigmoid(a[..., 64:] + cond[:, l, None, C + 64 * jc:C + 64 * jc + 64])
            z[..., cols] = th * sg
        zb = z.to(torch.bfloat16).float()
        rs = [sum(zb[..., 32 * kb:32 * kb + 32] @ _act_block(halves[h, kb], C) for kb in range(6))
              + b_rs[l, :, C * h:C * h + C] for h in range(2 if l < L - 1 else 1)]
        if l == L - 1:
            return ((skip + rs[0]) * m)[:, :T], torch.stack(xs, dim=1)
        xl = (xl + rs[0]) * m
        skip = skip + rs[1]
        xs.append(xl[:, :T])


def wn_stack_train_tiled_bwd(dout, xs, mask, cond, prep: BwdWeights, kernel_size: int):
    """The bf16 backward as its wgmma kernels compute it, in plain PyTorch:
    each layer's x_l, z, d_rs and dacts stored in bf16 in the tiled layout,
    every product read from ``prep``'s k blocks and from windows of the
    tiled intermediates, dcond and db_rs summed from the unrounded values,
    and the weight gradients summed over ``bwd_grid``'s row splits in order.
    Equals ``wn_stack_train_plain_bwd(..., bf16_compute=True)`` up to f32
    summation order; the CPU tests hold the layouts to it."""
    B, L, T, C = xs.shape
    C2, pad, k = 2 * C, kernel_size // 2, kernel_size
    Tr, Tp = tiled_rows(T)
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    valid = (torch.arange(Tr) < T).float()[None, :, None]

    def rows(t):   # [B, T, ch] → [B, Tr, ch], zero rows past T
        return F.pad(t, (0, 0, 0, Tr - T))

    m = rows(mask)
    g_out = rows(dout) * m
    splits = bwd_grid(B, T, k)["splits"]
    n_rk = Tr // WGRAD_ROWS
    dx = None
    dcond, dw_in, dw_rs, db_rs = [None] * L, [None] * L, [None] * L, [None] * L
    for l in reversed(range(L)):
        last = l == L - 1
        xb = to_tiled(bf(rows(xs[:, l])), Tp)
        dres = g_out if last else rows(dx) * m
        d_rs = torch.cat([dres, torch.zeros_like(g_out) if last else g_out], dim=-1)
        db_rs[l] = d_rs.sum(dim=(0, 1))[None]
        d_rs_t = to_tiled(bf(d_rs), Tp)
        d_rs_b = from_tiled(d_rs_t, Tr).float()
        z, dacts = torch.zeros(B, Tr, C), torch.zeros(B, Tr, C2)
        for jc in range(3):
            blocks = prep.act[l, jc].reshape(-1, ACT_BLOCK).float()
            a = torch.zeros(B, Tr, 128)
            for tap in range(k):
                x_tap = from_tiled(xb, Tr, tap - pad).float()
                for kb in range(3):
                    a = a + x_tap[..., 64 * kb:64 * kb + 64] @ _act_block(blocks[3 * tap + kb], 128)
            dz = sum(d_rs_b[..., 128 * kb:128 * kb + 128] @ _act_block(blocks[3 * k + kb], 64)
                     for kb in range(3))
            cols = slice(64 * jc, 64 * jc + 64)
            th = torch.tanh(a[..., :64] + cond[:, l, None, cols])
            sg = torch.sigmoid(a[..., 64:] + cond[:, l, None, C + 64 * jc:C + 64 * jc + 64])
            z[..., cols] = th * sg * valid
            dacts[..., cols] = dz * sg * (1.0 - th * th)
            dacts[..., C + 64 * jc:C + 64 * jc + 64] = dz * th * sg * (1.0 - sg)
        dcond[l] = dacts.sum(dim=1)
        z_t, dacts_t = to_tiled(bf(z), Tp), to_tiled(bf(dacts), Tp)
        dx_conv = torch.zeros(B, T, C)
        for tap in range(k):
            d_tap = from_tiled(dacts_t, T, pad - tap).float()
            for kb in range(C2 // 64):
                w = _act_block(prep.dx[l, tap, kb * DX_BLOCK:(kb + 1) * DX_BLOCK].float(), C)
                dx_conv = dx_conv + d_tap[..., 64 * kb:64 * kb + 64] @ w
        dx = dx_conv if last else dx_conv + dres[:, :T]
        # the weight gradients over each split's (batch item, WGRAD_ROWS) items
        win, wrs = torch.zeros(k * C, C2), torch.zeros(C, C2)
        for i0, i1 in splits:
            p_in, p_rs = torch.zeros(k * C, C2), torch.zeros(C, C2)
            for item in range(i0, i1):
                b, t0 = item // n_rk, (item % n_rk) * WGRAD_ROWS
                r = slice(HALO_ROWS + t0, HALO_ROWS + t0 + WGRAD_ROWS)
                q = dacts_t[b, :, r].transpose(0, 1).reshape(WGRAD_ROWS, C2).float()
                for tap in range(k):
                    rp = slice(r.start + tap - pad, r.stop + tap - pad)
                    p = xb[b, :, rp].transpose(0, 1).reshape(WGRAD_ROWS, C).float()
                    p_in[tap * C:(tap + 1) * C] += p.t() @ q
                p = z_t[b, :, r].transpose(0, 1).reshape(WGRAD_ROWS, C).float()
                p_rs += p.t() @ d_rs_t[b, :, r].transpose(0, 1).reshape(WGRAD_ROWS, C2).float()
            win, wrs = win + p_in, wrs + p_rs
        dw_in[l], dw_rs[l] = win.reshape(k, C, C2), wrs
    return (dx, torch.stack(dcond, dim=1), torch.stack(dw_in), torch.stack(dw_rs),
            torch.stack(db_rs))


def _fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    return fn


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _check(x, mask, cond, w_in, w_rs, b_rs, kernel_size):
    B, T, C = x.shape
    L = w_in.shape[0]
    expect = {"mask": (B, T, 1), "cond": (B, L, 2 * C),
              "w_in": (L, kernel_size, C, 2 * C), "w_rs": (L, C, 2 * C),
              "b_rs": (L, 1, 2 * C)}
    got = {"mask": mask, "cond": cond, "w_in": w_in, "w_rs": w_rs, "b_rs": b_rs}
    for name, shape in expect.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"wn_stack_train {name} {tuple(got[name].shape)} != {shape}")
        if got[name].device != x.device:
            raise ValueError("wn_stack_train inputs must share one device")
    if x.device.type != "cpu" and (C != _SUPPORTED_C or kernel_size % 2 == 0
                                   or kernel_size > 7):
        raise ValueError(f"wn_stack_train kernel takes C = {_SUPPORTED_C} and odd "
                         f"k <= 7; got C={C}, k={kernel_size}")


FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_fwd(x, mask, cond, w_in, w_rs, b_rs, kernel_size, bf16):
    """Kernel E's forward on the card → (out [B, T, C], xs [B, L, T, C]),
    f32: bf16 operands on wgmma, one library call for every layer, with the
    weights prepared once (``prepare_fwd_weights``); f32 operands on the
    3-pass TF32 mma.sync kernel, one call a layer."""
    global fwd_launches
    B, T, C = x.shape
    L = w_in.shape[0]
    dev = x.device
    mask, cond, b_rs = map(_f32, (mask, cond, b_rs))
    xs = torch.empty(B, L, T, C, device=dev)
    xs[:, 0].copy_(x.detach())
    out = torch.empty(B, T, C, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        skip = torch.zeros(B, T, C, device=dev)
        w = prepare_fwd_weights(w_in, w_rs)
        fn = _build.function("wn_stack_train", "wn_train_bf16_forward", FWD_ARGTYPES)
        status = fn(xs.data_ptr(), skip.data_ptr(), out.data_ptr(), mask.data_ptr(),
                    cond.data_ptr(), w.data_ptr(), b_rs.data_ptr(), B, T, L, kernel_size, stream)
        _build.check(status, "wn_stack_train forward")
    else:
        w_in, w_rs = _f32(w_in), _f32(w_rs)
        skip = torch.empty(B, T, C, device=dev)
        fn = _fn(_build.load("wn_stack_train"), "wn_train_fwd_layer", 8, 5)
        for l in range(L):
            status = fn(xs.data_ptr(), skip.data_ptr(), out.data_ptr(), mask.data_ptr(),
                        cond.data_ptr(), w_in[l].data_ptr(), w_rs[l].data_ptr(),
                        b_rs[l].data_ptr(), B, T, L, l, kernel_size, stream)
            _build.check(status, "wn_stack_train forward")
    fwd_launches += 1
    return out, xs


BF16_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_bwd_bf16(dout, xs, mask, cond, w_in, w_rs, kernel_size):
    """The bf16 backward on wgmma: one call runs every layer (bwd_act,
    bwd_dx and the weight gradients each) over bf16 intermediates in the
    tiled layout; the partial sums are added up here in a fixed order."""
    B, L, T, C = xs.shape
    dev = xs.device
    dout, mask, cond = map(_f32, (dout, mask, cond))
    prep = prepare_bwd_weights(w_in, w_rs)
    Tr, Tp = tiled_rows(T)
    n_tiles = Tr // TILE_ROWS
    xb, z = (torch.zeros(B, C // 8, Tp, 8, dtype=torch.bfloat16, device=dev) for _ in range(2))
    d_rs, dacts = (torch.zeros(B, 2 * C // 8, Tp, 8, dtype=torch.bfloat16, device=dev)
                   for _ in range(2))
    dx = [torch.empty(B, T, C, device=dev), torch.empty(B, T, C, device=dev)]
    part_dcond = torch.empty(L, B, n_tiles, 2 * C, device=dev)
    part_db = torch.empty_like(part_dcond)
    part_win = torch.empty(WGRAD_SPLITS_BF16, L, kernel_size * C, 2 * C, device=dev)
    part_wrs = torch.empty(WGRAD_SPLITS_BF16, L, C, 2 * C, device=dev)
    fn = _build.function("wn_stack_train", "wn_train_bf16_backward", BF16_ARGTYPES)
    status = fn(xs.data_ptr(), mask.data_ptr(), cond.data_ptr(), prep.act.data_ptr(),
                prep.dx.data_ptr(), dout.data_ptr(), dx[0].data_ptr(), dx[1].data_ptr(),
                xb.data_ptr(), z.data_ptr(), d_rs.data_ptr(), dacts.data_ptr(),
                part_dcond.data_ptr(), part_db.data_ptr(), part_win.data_ptr(),
                part_wrs.data_ptr(), B, T, L, kernel_size,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "wn_stack_train backward")
    return (dx[(L - 1) % 2], part_dcond.sum(dim=2).transpose(0, 1),
            part_win.sum(dim=0).reshape(L, kernel_size, C, 2 * C), part_wrs.sum(dim=0),
            part_db.sum(dim=(1, 2))[:, None])


def _launch_bwd_f32(dout, xs, mask, cond, w_in, w_rs, kernel_size):
    """The f32 backward: per layer the gate, dx and the two weight-gradient
    products on 3-pass TF32 mma.sync, over f32 intermediates."""
    B, L, T, C = xs.shape
    dev = xs.device
    dout, mask, cond, w_in, w_rs = map(_f32, (dout, mask, cond, w_in, w_rs))
    w_in_t = w_in.transpose(-1, -2).contiguous()   # [L, k, 2C, C]
    w_rs_t = w_rs.transpose(-1, -2).contiguous()   # [L, 2C, C]
    lib = _build.load("wn_stack_train")
    act = _fn(lib, "wn_train_bwd_act", 12, 5)
    dxk = _fn(lib, "wn_train_bwd_dx", 5, 4)
    wgrad = _fn(lib, "wn_train_wgrad", 3, 8)
    tile = lib.wn_train_row_tile()
    n_tiles = -(-T // tile)
    z = torch.empty(B, T, C, device=dev)
    d_rs = torch.empty(B, T, 2 * C, device=dev)
    dacts = torch.empty_like(d_rs)
    dx = [torch.empty(B, T, C, device=dev), torch.empty(B, T, C, device=dev)]
    part_dcond = torch.empty(L, B, n_tiles, 2 * C, device=dev)
    part_db = torch.empty_like(part_dcond)
    part_win = torch.empty(WGRAD_SPLITS, L, kernel_size * C, 2 * C, device=dev)
    part_wrs = torch.empty(WGRAD_SPLITS, L, C, 2 * C, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cur = 0
    for l in reversed(range(L)):
        nxt = dx[1 - cur]  # dL/dx_{l+1}; not read at the last layer
        status = act(xs.data_ptr(), mask.data_ptr(), cond.data_ptr(), w_in[l].data_ptr(),
                     w_rs_t[l].data_ptr(), dout.data_ptr(), nxt.data_ptr(), z.data_ptr(),
                     d_rs.data_ptr(), dacts.data_ptr(), part_dcond[l].data_ptr(),
                     part_db[l].data_ptr(), B, T, L, l, kernel_size, stream)
        _build.check(status, "wn_stack_train backward (gate)")
        status = dxk(dacts.data_ptr(), w_in_t[l].data_ptr(), nxt.data_ptr(), mask.data_ptr(),
                     dx[cur].data_ptr(), B, T, kernel_size, int(l == L - 1), stream)
        _build.check(status, "wn_stack_train backward (dx)")
        # Σ over all B·T rows: shifted x_l with dacts → dW_in, z with d_rs → dW_rs
        for p, p_bstride, taps, q, part in ((xs[:, l], L * T * C, kernel_size, dacts, part_win),
                                            (z, T * C, 1, d_rs, part_wrs)):
            status = wgrad(p.data_ptr(), q.data_ptr(), part[:, l].data_ptr(), p_bstride,
                           taps, C, 2 * C, B, T, WGRAD_SPLITS, part.stride(0), stream)
            _build.check(status, "wn_stack_train backward (weights)")
        cur = 1 - cur
    return (dx[1 - cur], part_dcond.sum(dim=2).transpose(0, 1),
            part_win.sum(dim=0).reshape(L, kernel_size, C, 2 * C), part_wrs.sum(dim=0),
            part_db.sum(dim=(1, 2))[:, None])


def _launch_bwd(dout, xs, mask, cond, w_in, w_rs, kernel_size, bf16):
    """Kernel E's backward on the card: bf16 operands on wgmma, f32 on the
    3-pass TF32 mma.sync kernels."""
    global bwd_launches
    launch = _launch_bwd_bf16 if bf16 else _launch_bwd_f32
    grads = launch(dout, xs, mask, cond, w_in, w_rs, kernel_size)
    bwd_launches += 1
    return grads


class _WNStackTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, cond, w_in, w_rs, b_rs, kernel_size, bf16):
        if x.device.type == "cpu":
            args = [t.detach().float() for t in (x, mask, cond, w_in, w_rs, b_rs)]
            out, xs = wn_stack_train_plain_fwd(*args, kernel_size, bf16)
        else:
            out, xs = _launch_fwd(x, mask, cond, w_in, w_rs, b_rs, kernel_size, bf16)
        ctx.save_for_backward(xs, mask, cond, w_in, w_rs, b_rs)
        ctx.kernel_size, ctx.bf16, ctx.x_dtype = kernel_size, bf16, x.dtype
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        xs, mask, cond, w_in, w_rs, b_rs = ctx.saved_tensors
        if xs.device.type == "cpu":
            args = [t.float() for t in (dout, xs, mask, cond, w_in, w_rs)]
            grads = wn_stack_train_plain_bwd(*args, ctx.kernel_size, ctx.bf16)
        else:
            grads = _launch_bwd(dout, xs, mask, cond, w_in, w_rs, ctx.kernel_size, ctx.bf16)
        dx, dcond, dw_in, dw_rs, db_rs = grads
        return (dx.to(ctx.x_dtype), None, dcond.to(cond.dtype), dw_in.to(w_in.dtype),
                dw_rs.to(w_rs.dtype), db_rs.to(b_rs.dtype), None, None)


def wn_stack_train(x, mask, cond, w_in, w_rs, b_rs, kernel_size: int,
                   bf16_compute=None):
    """Kernel E on CUDA tensors, its plain forward and backward on CPU
    tensors; differentiable in x, cond and the weights.  Shapes as
    ``wn_stack_train_plain_fwd``; ``bf16_compute`` defaults to x being bf16.
    → out [B, T, C] in x's dtype."""
    _check(x, mask, cond, w_in, w_rs, b_rs, kernel_size)
    if bf16_compute is None:
        bf16_compute = x.dtype == torch.bfloat16
    if bf16_compute and x.device.type != "cpu" and kernel_size > BF16_MAX_K:
        raise ValueError(f"wn_stack_train's bf16 kernels take k <= {BF16_MAX_K}; "
                         f"got k={kernel_size}")
    return _WNStackTrain.apply(x, mask, cond, w_in, w_rs, b_rs, kernel_size,
                               bool(bf16_compute))
