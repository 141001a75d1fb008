"""Kernel F: trainable relative-position self-attention with dropout on the
probabilities, forward and backward.

Replaces ``vispeech_tpu/ops/pallas/flash_attention_train.py::
relative_self_attention_train`` (custom VJP; bodies ``_fwd_kernel`` and
``_bwd_kernel``) with ``csrc/rel_attention_train.cu``:

* forward: kernel A's online softmax, plus the per-row logsumexp and the
  dropout keep mask on the probabilities;
* backward: one pass per 32 query rows (dq, the banded drel_k / drel_v
  partial sums per tile, and D = rowsum(dO ∘ O)), then one pass per 32
  keys (dk, dv); both rebuild p = exp(s − lse) and the same keep mask.

The keep mask is a counter-based hash of (seed, b·H + h, query row, key
column) (``dropout_keep``), so it does not depend on any tiling: the
backward regenerates the forward's mask exactly, and the plain version
computes the same bits with torch integer ops.  The TPU kernel's PRNG bits
differ, so against JAX only rate 0 compares.

Key positions are masked with −1e4, as kernel A does, so wholly masked rows
stay finite and padded key columns get exactly zero dk and dv.  Compute-
bound (4·T²·d flops forward, ~2.5× that backward, per batch-head); f32
CUDA cores in this version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vispeech_tpu_torch.ops.kernels import _build

NEG_FILL = -1e4
fwd_launches = 0
bwd_launches = 0

_MASK32 = 0xFFFFFFFF
_K_BH, _K_ROW, _K_COL = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _mul32(h, c: int):
    """(h · c) mod 2^32 for h < 2^32 (an int or an int64 tensor), in 16-bit
    limbs so that no int64 product overflows."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """A key is kept when its 32-bit hash is >= this."""
    return min(int(min(max(rate, 0.0), 1.0) * 4294967296.0), _MASK32)


def dropout_keep(seed: int, rate: float, B: int, H: int, T: int, device=None):
    """The keep mask [B, H, T, T] (bool) of ``seed`` at ``rate``:
    hash = fmix(fmix(fmix(seed ^ (bh+1)·K1) ^ (t+1)·K2) ^ (j+1)·K3)."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    a = _fmix32((seed & _MASK32) ^ _mul32(ar(B * H) + 1, _K_BH))
    rk = _fmix32(a[:, None] ^ _mul32(ar(T) + 1, _K_ROW)[None])
    h = _fmix32(rk[:, :, None] ^ _mul32(ar(T) + 1, _K_COL)[None, None])
    return (h >= keep_threshold(rate)).reshape(B, H, T, T)


def draw_seed(generator=None) -> int:
    """A dropout seed from ``generator`` (a CPU generator: no device sync)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


def _r(t, bf16: bool):
    return t.to(torch.bfloat16).float() if bf16 else t


def _bands(T: int, window: int):
    """(δ, rows) per diagonal s − t = δ: rows the query rows it covers."""
    for delta in range(-window, window + 1):
        n = T - abs(delta)
        if n > 0:
            start = max(-delta, 0)
            yield delta, slice(start, start + n)


def _diags(m, T: int, window: int):
    """[B, H, T, T] → its 2w+1 diagonals as [B, H, W, T], row-aligned, zeros
    where a diagonal leaves the matrix."""
    out = m.new_zeros(m.shape[0], m.shape[1], 2 * window + 1, T)
    for delta, rows in _bands(T, window):
        out[:, :, delta + window, rows] = m.diagonal(delta, -2, -1)
    return out


def _scores(qs, k, rel_k, key_mask, window, bf16):
    T = qs.shape[2]
    scores = torch.matmul(qs, _r(k, bf16).transpose(-1, -2))
    q_rel = torch.einsum("bhtd,hwd->bhtw", qs, _r(rel_k, bf16).expand(qs.shape[1], -1, -1))
    for delta, rows in _bands(T, window):
        scores.diagonal(delta, -2, -1).add_(q_rel[:, :, rows, delta + window])
    return torch.where(key_mask[:, None, None, :] > 0, scores,
                       torch.full_like(scores, NEG_FILL))


def relative_self_attention_train_plain_fwd(q, k, v, rel_k, rel_v, key_mask, seed: int,
                                            rate: float, window: int = 4,
                                            bf16_compute: bool = False):
    """All f32.  q, k, v [B, H, T, d]; rel_k, rel_v [n_rel, 2w+1, d];
    key_mask [B, T] → (out [B, H, T, d], lse [B, H, T])."""
    B, H, T, d = q.shape
    qs = _r(q * (1.0 / math.sqrt(d)), bf16_compute)
    scores = _scores(qs, k, rel_k, key_mask, window, bf16_compute)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    if rate > 0.0:
        p = p * (dropout_keep(seed, rate, B, H, T, q.device).to(p.dtype) / (1.0 - rate))
    out = torch.matmul(_r(p, bf16_compute), _r(v, bf16_compute))
    rv = rel_v.expand(H, -1, -1)
    for delta, rows in _bands(T, window):
        out[:, :, rows] += p.diagonal(delta, -2, -1)[..., None] * rv[None, :, None, delta + window]
    return out, lse


def relative_self_attention_train_plain_bwd(dout, q, k, v, rel_k, rel_v, key_mask, lse,
                                            seed: int, rate: float, window: int = 4,
                                            bf16_compute: bool = False):
    """``_bwd_kernel``'s formulas (``flash_attention_train.py:169-256``),
    written out.  → (dq, dk, dv, drel_k, drel_v), all f32."""
    B, H, T, d = q.shape
    n_rel = rel_k.shape[0]
    scale = 1.0 / math.sqrt(d)
    r = lambda t: _r(t, bf16_compute)  # noqa: E731
    qs = r(q * scale)
    p = torch.exp(_scores(qs, k, rel_k, key_mask, window, bf16_compute) - lse[..., None])
    keep = None
    if rate > 0.0:
        keep = dropout_keep(seed, rate, B, H, T, q.device).to(p.dtype) / (1.0 - rate)
    pd = p if keep is None else p * keep
    doc = r(dout)
    dpd = torch.matmul(doc, r(v).transpose(-1, -2))
    do_relv = torch.einsum("bhtd,hwd->bhtw", doc, r(rel_v).expand(H, -1, -1))
    for delta, rows in _bands(T, window):
        dpd.diagonal(delta, -2, -1).add_(do_relv[:, :, rows, delta + window])
    drel_v = torch.einsum("bhwt,bhtd->hwd", r(_diags(pd, T, window)), doc)
    dv = torch.matmul(r(pd).transpose(-1, -2), doc)
    dp = dpd if keep is None else dpd * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_diag = _diags(ds, T, window)
    dqs = torch.matmul(r(ds), r(k)) + torch.einsum(
        "bhwt,hwd->bhtd", ds_diag, rel_k.expand(H, -1, -1))
    drel_k = torch.einsum("bhwt,bhtd->hwd", r(ds_diag), qs)
    dk = torch.matmul(r(ds).transpose(-1, -2), qs)
    if n_rel == 1:
        drel_k, drel_v = drel_k.sum(0, keepdim=True), drel_v.sum(0, keepdim=True)
    return dqs * scale, dk, dv, drel_k, drel_v


def _check(q, k, v, rel_k, rel_v, key_mask, window):
    B, H, T, d = q.shape
    n_rel = rel_k.shape[0]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if n_rel not in (1, H) or rel_k.shape != (n_rel, 2 * window + 1, d) \
            or rel_v.shape != rel_k.shape:
        raise ValueError(f"rel tables {tuple(rel_k.shape)} / {tuple(rel_v.shape)}")
    if key_mask.shape != (B, T):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} != {(B, T)}")
    for t in (k, v, rel_k, rel_v, key_mask):
        if t.device != q.device:
            raise ValueError("rel_attention_train inputs must share one device")
    if q.device.type != "cpu" and (d not in (64, 96) or window > 4):
        raise ValueError(f"rel_attention_train kernel takes d in (64, 96), window <= 4; "
                         f"got d={d}, window={window}")


def _fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return fn


def _f32(t):
    return t.detach().float().contiguous()


def _launch_fwd(q, k, v, rel_k, rel_v, key_mask, seed, rate, window, bf16):
    global fwd_launches
    B, H, T, d = q.shape
    args = [_f32(t) for t in (q, k, v, rel_k, rel_v, key_mask)]
    out = torch.empty_like(args[0])
    lse = torch.empty(B, H, T, device=q.device)
    fn = _fn(_build.load("rel_attention_train"), "rel_attn_train_fwd", 8, 7)
    status = fn(*(t.data_ptr() for t in args), out.data_ptr(), lse.data_ptr(), B, H, T, d,
                rel_k.shape[0], window, int(bf16), seed & 0xFFFFFFFF, keep_threshold(rate),
                rate, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "rel_attention_train forward")
    fwd_launches += 1
    return out, lse


def _launch_bwd(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate, window, bf16):
    global bwd_launches
    B, H, T, d = q.shape
    n_rel, W = rel_k.shape[0], 2 * window + 1
    args = [_f32(t) for t in (q, k, v, rel_k, rel_v, key_mask, out, lse, dout)]
    lib = _build.load("rel_attention_train")
    n_tiles = -(-T // lib.rel_attn_train_tile())
    dq, dk, dv = (torch.empty_like(args[0]) for _ in range(3))
    rowd = torch.empty(B, H, T, device=q.device)             # D = rowsum(dO ∘ O)
    qrel = torch.empty(B, H, T, W, device=q.device)          # q̂·rel_k per row
    dorel = torch.empty_like(qrel)                           # dO·rel_v per row
    part_k = torch.empty(B * H, n_tiles, W, d, device=q.device)
    part_v = torch.empty_like(part_k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (B, H, T, d, n_rel, window, int(bf16), seed & 0xFFFFFFFF,
              keep_threshold(rate), rate, stream)
    fn_q = _fn(lib, "rel_attn_train_bwd_q", 15, 7)
    status = fn_q(*(t.data_ptr() for t in args), dq.data_ptr(), rowd.data_ptr(),
                  qrel.data_ptr(), dorel.data_ptr(), part_k.data_ptr(), part_v.data_ptr(),
                  *common)
    _build.check(status, "rel_attention_train backward (dq)")
    fn_kv = _fn(lib, "rel_attn_train_bwd_kv", 11, 7)
    status = fn_kv(*(args[i].data_ptr() for i in (0, 1, 2, 5, 7, 8)), rowd.data_ptr(),
                   qrel.data_ptr(), dorel.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common)
    _build.check(status, "rel_attention_train backward (dk, dv)")
    bwd_launches += 1
    part_k = part_k.reshape(B, H, n_tiles, W, d).sum(dim=2)
    part_v = part_v.reshape(B, H, n_tiles, W, d).sum(dim=2)
    dims = (0, 1) if n_rel == 1 else (0,)
    drel_k = part_k.sum(dim=dims).reshape(n_rel, W, d)
    drel_v = part_v.sum(dim=dims).reshape(n_rel, W, d)
    return dq, dk, dv, drel_k, drel_v


class _RelAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_k, rel_v, key_mask, seed, rate, window, bf16):
        if q.device.type == "cpu":
            f = [t.detach().float() for t in (q, k, v, rel_k, rel_v, key_mask)]
            out, lse = relative_self_attention_train_plain_fwd(*f, seed, rate, window, bf16)
        else:
            out, lse = _launch_fwd(q, k, v, rel_k, rel_v, key_mask, seed, rate, window, bf16)
        ctx.save_for_backward(q, k, v, rel_k, rel_v, key_mask, out, lse)
        ctx.cfg = (seed, rate, window, bf16)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_k, rel_v, key_mask, out, lse = ctx.saved_tensors
        seed, rate, window, bf16 = ctx.cfg
        if q.device.type == "cpu":
            f = [t.float() for t in (dout, q, k, v, rel_k, rel_v, key_mask, lse)]
            grads = relative_self_attention_train_plain_bwd(*f, seed, rate, window, bf16)
        else:
            grads = _launch_bwd(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate,
                                window, bf16)
        dq, dk, dv, drel_k, drel_v = grads
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), drel_k.to(rel_k.dtype),
                drel_v.to(rel_v.dtype), None, None, None, None, None)


def relative_self_attention_train(q, k, v, rel_k, rel_v, key_mask, seed: int = 0,
                                  rate: float = 0.0, window: int = 4, bf16_compute=None):
    """Kernel F on CUDA tensors, its plain forward and backward on CPU
    tensors; differentiable in q, k, v, rel_k and rel_v.  ``rate`` is the
    dropout rate on the probabilities, ``seed`` picks the keep mask
    (``dropout_keep``); ``bf16_compute`` (default: q is bf16) rounds every
    matmul operand to bf16, softmax and accumulators staying f32.
    → out [B, H, T, d] in q's dtype."""
    _check(q, k, v, rel_k, rel_v, key_mask, window)
    if bf16_compute is None:
        bf16_compute = q.dtype == torch.bfloat16
    return _RelAttentionTrain.apply(q, k, v, rel_k, rel_v, key_mask, int(seed), float(rate),
                                    window, bool(bf16_compute))
