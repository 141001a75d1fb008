"""Kernel E: the trainable dilation-1 WaveNet stack, forward and backward.

Replaces ``vispeech_tpu/ops/pallas/wn_stack_train.py::wn_stack_train``
(custom VJP; bodies ``_fwd_kernel`` and ``_bwd_kernel``) with
``csrc/wn_stack_train.cu``.  The forward is kernel B's math and also keeps
every layer's input ``xs[b, l]`` for the backward.  The backward walks the
layers in reverse, rematerializes the gate from ``xs`` and emits dx, dcond
and the weight gradients; weight and bias gradients are per-tile partial
sums reduced here in a fixed order, so a run is reproducible bit for bit.

The CUDA kernels run one layer per launch with a halo of k//2 frames (no
recomputed L·(k//2) halo as kernel B has, so any depth works): a forward
layer, and per backward layer the gate and dacts, the input gradient, and
the two weight-gradient products.  Compute-bound (~11 GFLOP per layer
forward at B = 12, T = 1024, C = 192); every product on the tensor cores
as mma.sync TF32, one pass for bf16 operands, three for f32.

``bf16_compute``: every matmul operand is rounded to bf16, every
accumulator, carry and gate stays f32, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes

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
WGRAD_SPLITS = 4   # row splits of each weight-gradient product (fixed: deterministic sums)


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


def _launch_fwd(x, mask, cond, w_in, w_rs, b_rs, kernel_size, bf16):
    global fwd_launches
    B, T, C = x.shape
    L = w_in.shape[0]
    mask, cond, w_in, w_rs, b_rs = map(_f32, (mask, cond, w_in, w_rs, b_rs))
    xs = torch.empty(B, L, T, C, device=x.device)
    xs[:, 0].copy_(x.detach())
    skip = torch.empty(B, T, C, device=x.device)
    out = torch.empty_like(skip)
    fn = _fn(_build.load("wn_stack_train"), "wn_train_fwd_layer", 8, 6)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for l in range(L):
        status = fn(xs.data_ptr(), skip.data_ptr(), out.data_ptr(), mask.data_ptr(),
                    cond.data_ptr(), w_in[l].data_ptr(), w_rs[l].data_ptr(),
                    b_rs[l].data_ptr(), B, T, L, l, kernel_size, int(bf16), stream)
        _build.check(status, "wn_stack_train forward")
    fwd_launches += 1
    return out, xs


def _launch_bwd(dout, xs, mask, cond, w_in, w_rs, kernel_size, bf16):
    global bwd_launches
    B, L, T, C = xs.shape
    dev = xs.device
    dout, mask, cond, w_in, w_rs = map(_f32, (dout, mask, cond, w_in, w_rs))
    w_in_t = w_in.transpose(-1, -2).contiguous()   # [L, k, 2C, C]
    w_rs_t = w_rs.transpose(-1, -2).contiguous()   # [L, 2C, C]
    lib = _build.load("wn_stack_train")
    act = _fn(lib, "wn_train_bwd_act", 12, 6)
    dxk = _fn(lib, "wn_train_bwd_dx", 5, 5)
    wgrad = _fn(lib, "wn_train_wgrad", 3, 9)
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
                     part_db[l].data_ptr(), B, T, L, l, kernel_size, int(bf16), stream)
        _build.check(status, "wn_stack_train backward (gate)")
        status = dxk(dacts.data_ptr(), w_in_t[l].data_ptr(), nxt.data_ptr(), mask.data_ptr(),
                     dx[cur].data_ptr(), B, T, kernel_size, int(l == L - 1), int(bf16),
                     stream)
        _build.check(status, "wn_stack_train backward (dx)")
        # Σ over all B·T rows: shifted x_l with dacts → dW_in, z with d_rs → dW_rs
        for p, p_bstride, taps, q, part in ((xs[:, l], L * T * C, kernel_size, dacts, part_win),
                                            (z, T * C, 1, d_rs, part_wrs)):
            status = wgrad(p.data_ptr(), q.data_ptr(), part[:, l].data_ptr(), p_bstride,
                           taps, C, 2 * C, B, T, WGRAD_SPLITS, part.stride(0), int(bf16),
                           stream)
            _build.check(status, "wn_stack_train backward (weights)")
        cur = 1 - cur
    bwd_launches += 1
    return (dx[1 - cur], part_dcond.sum(dim=2).transpose(0, 1),
            part_win.sum(dim=0).reshape(L, kernel_size, C, 2 * C), part_wrs.sum(dim=0),
            part_db.sum(dim=(1, 2))[:, None])


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
    return _WNStackTrain.apply(x, mask, cond, w_in, w_rs, b_rs, kernel_size,
                               bool(bf16_compute))
