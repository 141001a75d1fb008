"""Kernel F: trainable relative-position self-attention with dropout on the
probabilities, forward and backward.

Replaces ``vispeech_tpu/ops/pallas/flash_attention_train.py::
relative_self_attention_train`` (custom VJP; bodies ``_fwd_kernel`` and
``_bwd_kernel``) with ``csrc/rel_attention_train.cu``:

* forward with bf16 operands (``bf16_compute``): one launch on wgmma bf16
  (namespace ``fwd16``), which reads q, k and v as bf16 in place through
  their strides (``_operand``; an f32 q goes in as q̂) and the rel tables
  and key mask as f32 or bf16 (``_table``).  A block owns 64 query rows and
  walks 64-key tiles with an online softmax (the row max rescales the
  accumulator, p is rounded to bf16 before its rescale); the band's scores
  are kept, and its rel_v term is added once lse is known.
  ``relative_self_attention_train_tiled_fwd`` is its data flow in plain
  PyTorch, which the CPU tests hold to the plain forward;
* forward in f32: kernel A's online softmax on CUDA cores, plus the per-row
  logsumexp and the dropout keep mask on the probabilities;
* backward with bf16 operands (``bf16_compute``): one library call of two
  launches on wgmma bf16.  It reads q, k, v and dO as bf16, the model's
  type (``_operand`` rounds an f32 one; an f32 q goes in as q̂, rounded
  once as the plain version rounds it).  A prep kernel makes bf16
  copies of q̂ = bf16(q·scale), k, v and dO once a call, in 64-row tiles of
  wgmma core matrices (``to_bwd_tiles``), with each row's lse, D =
  rowsum(dO ∘ O), hash key and band terms; then the q pass (64 query rows
  a warpgroup: dq and the banded drel_k / drel_v partial sums per tile)
  and the kv pass (64 keys a warpgroup, the transposed products: dk, dv)
  run in one launch.
  ``relative_self_attention_train_tiled_bwd`` is its data flow in plain
  PyTorch, which the CPU tests hold to the plain backward;
* backward in f32: one pass per 32 query rows, then one per 32 keys, on
  CUDA cores.  Every backward rebuilds p = exp(s − lse) and the same keep
  mask.

The keep mask is a counter-based hash of (seed, b·H + h, query row, key
column) (``dropout_keep``), so it does not depend on any tiling: the
backward regenerates the forward's mask exactly, and the plain version
computes the same bits with torch integer ops.  The TPU kernel's PRNG bits
differ, so against JAX only rate 0 compares.

Key positions are masked with −1e4, as kernel A does, so wholly masked rows
stay finite and padded key columns get exactly zero dk and dv.  Compute-
bound (4·T²·d flops forward, 2.5× that backward, per batch-head).  The f32
forward and backward run on CUDA cores.  The drel partial sums are added in
a fixed order: no atomics, the same bits from run to run.
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


FWD_ROWS = 64      # query rows a block of the bf16 forward (fwd16::FWD_ROWS)
FWD_KEYS = 64      # keys a tile of the bf16 forward (bwd16::BT)


def relative_self_attention_train_tiled_fwd(q, k, v, rel_k, rel_v, key_mask, seed: int,
                                            rate: float, window: int = 4, kv=None):
    """The bf16 forward's data flow in plain PyTorch (CPU): q̂ = bf16(q·scale)
    in 64-row tiles with each row's band record q̂·rel_k (bf16 operands); per
    tile, over 64-key tiles of bf16 k and v (``kv``: such copies [B·H, Tp, d],
    zero past T), S with the band on the tile pairs it crosses, −1e4 for a
    masked key and −∞ past T, the online max rescaling the accumulator and
    the row sum, p = exp(s − m) times the keep factor rounded to bf16 before
    its rescale, O += P·V, and the band's scores kept (−∞ where dropped);
    then out = O/l + Σ_w exp(s_w − lse)·rel_v[w]/(1 − rate), lse = m + log l.
    → (out [B, H, T, d], lse [B, H, T])."""
    B, H, T, d = q.shape
    BH, W, n_rel = B * H, 2 * window + 1, rel_k.shape[0]
    Tp, nt = bwd_rows(T)
    bt = FWD_KEYS
    rb = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    pad = lambda x: torch.cat((x, x.new_zeros(BH, Tp - T, d)), 1)  # noqa: E731
    qh = pad(rb(q.float().reshape(BH, T, d) * (1.0 / math.sqrt(d))))
    kh, vh = kv if kv is not None else (pad(rb(t.float().reshape(BH, T, d))) for t in (k, v))
    per_bh = lambda t: t.float().expand(H, W, d).repeat(B, 1, 1) if n_rel == 1 \
        else t.float().repeat(B, 1, 1)  # noqa: E731
    rk, rv = rb(per_bh(rel_k)), per_bh(rel_v)                  # [BH, W, d]
    kin = key_mask.float().repeat_interleave(H, 0)             # [BH, T]
    kin = torch.cat((kin, kin.new_zeros(BH, Tp - T)), 1)
    thresh, inv = keep_threshold(rate), 1.0 / (1.0 - rate)
    a = _fmix32((seed & _MASK32) ^ _mul32(torch.arange(BH, dtype=torch.int64) + 1, _K_BH))
    ar = torch.arange(bt)
    out = torch.zeros(BH, Tp, d)
    lse = torch.zeros(BH, Tp)
    for qt in range(nt):
        rows = slice(qt * FWD_ROWS, (qt + 1) * FWD_ROWS)
        t = (qt * FWD_ROWS + ar)[:, None]
        rkey = _fmix32(a[:, None] ^ _mul32(t[:, 0] + 1, _K_ROW)[None])[:, :, None]
        qr = torch.einsum("brd,bwd->brw", qh[:, rows], rk)
        m = torch.full((BH, FWD_ROWS, 1), -math.inf)
        l = torch.zeros(BH, FWD_ROWS, 1)
        acc = torch.zeros(BH, FWD_ROWS, d)
        bs = torch.full((BH, FWD_ROWS, W), -math.inf)
        for kt in range(nt):
            cols = slice(kt * bt, (kt + 1) * bt)
            j = (kt * bt + ar)[None]
            s = qh[:, rows] @ kh[:, cols].transpose(1, 2)
            delta = j - t
            in_band = (delta.abs() <= window) & (abs(kt - qt) <= 1)
            bi = (delta + window).clamp(0, W - 1).expand(BH, -1, -1)
            s = s + torch.where(in_band, torch.gather(qr, 2, bi), 0.0)
            s = torch.where(kin[:, None, cols] > 0, s, torch.full_like(s, NEG_FILL))
            s = torch.where(j < T, s, torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            kf = torch.ones_like(s)
            if thresh:
                h = _fmix32(rkey ^ _mul32(j + 1, _K_COL))
                kf = torch.where(h >= thresh, torch.full_like(s, inv), torch.zeros_like(s))
            acc = acc * corr + rb(p * kf) @ vh[:, cols]
            kept = torch.where(kf > 0, s, torch.full_like(s, -math.inf))
            for w in range(W):                  # a row's key at δ = w − window, if here
                at = in_band & (bi == w)
                bs[..., w] = torch.where(at.any(-1), torch.where(at, kept, 0.0).sum(-1),
                                         bs[..., w])
        lse_t = m + torch.log(l)
        band = inv * torch.exp(bs - lse_t)
        out[:, rows] = acc / l + torch.einsum("brw,bwd->brd", band, rv)
        lse[:, rows] = lse_t[..., 0]
    return out[:, :T].reshape(B, H, T, d), lse[:, :T].reshape(B, H, T)


BWD_TILE = 64      # rows, or keys, of a bf16 backward tile (bwd16::BT)
BAND_ROW = 18      # floats of a row's band record: q̂·rel_k[w], then dO·rel_v[w] (bwd16::BAND)
_MAXW = 9


def bwd_rows(T: int):
    """(Tp, tiles): T rounded up to whole 64-row tiles of the bf16 backward."""
    Tp = -(-T // BWD_TILE) * BWD_TILE
    return Tp, Tp // BWD_TILE


def bwd_grid(B: int, H: int, T: int) -> dict:
    """The bf16 backward's two launches, (grid, threads) each: prep, and both
    passes in one (z = 0 the q pass, 1 the kv pass)."""
    nt = bwd_rows(T)[1]
    return {"prep": ((nt, B * H), 128), "qkv": ((nt, B * H, 2), 128)}


def to_bwd_tiles(x: torch.Tensor, Tp: int) -> torch.Tensor:
    """x [BH, T, d] → its bf16 copy as the kernels hold it: [BH, Tp/64, d/8,
    64, 8], 64-row tiles of 8-column chunks of 16-byte rows, zero past T."""
    BH, T, d = x.shape
    out = torch.zeros(BH, Tp, d, dtype=torch.bfloat16, device=x.device)
    out[:, :T] = x
    return out.reshape(BH, Tp // BWD_TILE, BWD_TILE, d // 8, 8).permute(0, 1, 3, 2, 4).contiguous()


def from_bwd_tiles(x: torch.Tensor) -> torch.Tensor:
    """``to_bwd_tiles``' layout → [BH, Tp, d] in f32."""
    BH, nt, nc, bt, _ = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(BH, nt * bt, nc * 8).float()


def _bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    return (((h + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32).view(torch.float32)


def _f32_to_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def bwd_prep(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed: int, window: int) -> dict:
    """What ``prep_kernel`` writes, in plain PyTorch: the tiled bf16 copies
    of q̂ = bf16(q·scale), k, v, dO; ``stat`` [BH, Tp/64, 3, 64] (lse, +inf
    past T; D = rowsum(dO ∘ O); the row's hash key as bits); ``band``
    [BH, Tp, 18] (q̂·rel_k[w], dO·rel_v[w], bf16 operands); ``kinfo`` [B, Tp]
    (1 kept, 0 masked, −1 past T)."""
    B, H, T, d = q.shape
    BH, W = B * H, 2 * window + 1
    Tp, nt = bwd_rows(T)
    flat = lambda t: t.float().reshape(BH, T, d)  # noqa: E731
    qh = to_bwd_tiles(flat(q) * (1.0 / math.sqrt(d)), Tp)
    tiles = {"qh": qh, "kh": to_bwd_tiles(flat(k), Tp), "vh": to_bwd_tiles(flat(v), Tp),
             "doh": to_bwd_tiles(flat(dout), Tp)}
    stat = torch.zeros(BH, Tp, 3)
    stat[:, :, 0] = math.inf
    stat[:, :T, 0] = lse.float().reshape(BH, T)
    stat[:, :T, 1] = (_r(flat(dout), True) * flat(out)).sum(-1)     # dO as the kernels read it
    a = _fmix32((seed & _MASK32) ^ _mul32(torch.arange(BH, dtype=torch.int64) + 1, _K_BH))
    rows = _fmix32(a[:, None] ^ _mul32(torch.arange(Tp, dtype=torch.int64) + 1, _K_ROW)[None])
    stat[:, :, 2] = _bits_to_f32(rows)
    stat = stat.reshape(BH, nt, BWD_TILE, 3).transpose(2, 3).contiguous()
    n_rel = rel_k.shape[0]
    tab = lambda t: _r(t.float(), True).expand(H, W, d).repeat(B, 1, 1) if n_rel == 1 \
        else _r(t.float(), True).repeat(B, 1, 1)  # noqa: E731
    band = torch.zeros(BH, Tp, BAND_ROW)
    band[:, :, :W] = torch.einsum("btd,bwd->btw", from_bwd_tiles(qh), tab(rel_k))
    band[:, :, _MAXW:_MAXW + W] = torch.einsum("btd,bwd->btw", from_bwd_tiles(tiles["doh"]),
                                                tab(rel_v))
    kinfo = torch.full((B, Tp), -1.0)
    kinfo[:, :T] = (key_mask.float() > 0).float()
    return dict(tiles, stat=stat, band=band, kinfo=kinfo)


def _band_terms(band, t, j, window, transposed: bool):
    """The band's q̂·rel_k and dO·rel_v terms of a tile pair, zero off the
    band, with its positions: band [BH, 64, 18] of the tile's query rows, t
    and j [rows, cols] the elements' query row and key (rows are queries,
    or keys when ``transposed``).  → (qb, db, w = δ + window, in-band)."""
    delta = j - t
    in_band = delta.abs() <= window
    bi = (delta + window).clamp(0, _MAXW - 1)
    idx = (bi.t() if transposed else bi).expand(band.shape[0], -1, -1)
    terms = []
    for off in (0, _MAXW):
        x = torch.gather(band[..., off:off + _MAXW], 2, idx)
        terms.append(torch.where(in_band, x.transpose(1, 2) if transposed else x, 0.0))
    return terms[0], terms[1], bi, in_band


def _tile_probs(s, dp, qb, db, lse, dd, rk, kinfo, j, thresh, inv):
    """The kernels' per-element step on a tile pair: → (pd, ds)."""
    sc = torch.where(kinfo > 0, s + qb, torch.full_like(s, NEG_FILL))
    p = torch.where(kinfo >= 0, torch.exp(sc - lse), torch.zeros_like(s))
    kf = torch.ones_like(s)
    if thresh:
        h = _fmix32(rk ^ _mul32(j + 1, _K_COL))
        kf = torch.where(h >= thresh, torch.full_like(s, inv), torch.zeros_like(s))
    return p * kf, p * ((dp + db) * kf - dd)


def relative_self_attention_train_tiled_bwd(dout, q, k, v, rel_k, rel_v, key_mask, out, lse,
                                            seed: int, rate: float, window: int = 4,
                                            prep=None):
    """The bf16 backward's data flow in plain PyTorch (CPU): ``bwd_prep``'s
    tiled copies (or ``prep``, such a dict), the q pass over 64-row tiles
    with its per-tile band partials, the kv pass over 64-key tiles with the
    transposed products, and the partials summed in a fixed order.
    → (dq, dk, dv, drel_k, drel_v)."""
    B, H, T, d = q.shape
    BH, W, n_rel = B * H, 2 * window + 1, rel_k.shape[0]
    Tp, nt = bwd_rows(T)
    bt = BWD_TILE
    pre = prep or bwd_prep(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, window)
    qh, kh, vh, doh = (from_bwd_tiles(pre[n]) for n in ("qh", "kh", "vh", "doh"))
    stat, band = pre["stat"], pre["band"]
    kinfo = pre["kinfo"].repeat_interleave(H, 0)            # [BH, Tp]
    thresh, inv = keep_threshold(rate), 1.0 / (1.0 - rate)
    rb = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    ar = torch.arange(bt)
    rk_f32 = rel_k.float().expand(H, W, d).repeat(B, 1, 1) if n_rel == 1 \
        else rel_k.float().repeat(B, 1, 1)                  # [BH, W, d]
    dq = torch.zeros(BH, Tp, d)
    part_k = torch.zeros(BH, nt, W, d)
    part_v = torch.zeros_like(part_k)
    for qt in range(nt):                                    # q pass: 64 query rows a block
        rows = slice(qt * bt, qt * bt + bt)
        lse_t, dd_t = stat[:, qt, 0, :, None], stat[:, qt, 1, :, None]
        rk_t = _f32_to_bits(stat[:, qt, 2])[:, :, None]
        acc = torch.zeros(BH, bt, d)
        dsd = torch.zeros(BH, bt, _MAXW)
        pdd = torch.zeros_like(dsd)
        for kt in range(nt):
            cols = slice(kt * bt, kt * bt + bt)
            s = qh[:, rows] @ kh[:, cols].transpose(1, 2)
            dp = doh[:, rows] @ vh[:, cols].transpose(1, 2)
            t, j = (qt * bt + ar)[:, None], (kt * bt + ar)[None]
            qb, db, bi, in_band = _band_terms(band[:, rows], t, j, window, False)
            pd, ds = _tile_probs(s, dp, qb, db, lse_t, dd_t, rk_t, kinfo[:, None, cols], j,
                                 thresh, inv)
            for w in range(W):
                at = (in_band & (bi == w)).float()
                dsd[..., w] += (ds * at).sum(-1)
                pdd[..., w] += (pd * at).sum(-1)
            acc += rb(ds) @ kh[:, cols]
        dq[:, rows] = (acc + torch.einsum("brw,bwd->brd", dsd[..., :W], rk_f32)) / math.sqrt(d)
        part_k[:, qt] = torch.einsum("brw,brd->bwd", rb(dsd[..., :W]), qh[:, rows])
        part_v[:, qt] = torch.einsum("brw,brd->bwd", rb(pdd[..., :W]), doh[:, rows])
    dk = torch.zeros(BH, Tp, d)
    dv = torch.zeros(BH, Tp, d)
    for kt in range(nt):                                    # kv pass: 64 keys a block
        keys = slice(kt * bt, kt * bt + bt)
        gk = torch.zeros(BH, bt, d)
        gv = torch.zeros(BH, bt, d)
        for qt in range(nt):
            rows = slice(qt * bt, qt * bt + bt)
            st = qh[:, rows].transpose(1, 2)                # Sᵀ = K·q̂ᵀ: keys × queries
            s = kh[:, keys] @ st
            dp = vh[:, keys] @ doh[:, rows].transpose(1, 2)
            t, j = (qt * bt + ar)[None], (kt * bt + ar)[:, None]
            qb, db, _, _ = _band_terms(band[:, rows], t, j, window, True)
            pd, ds = _tile_probs(s, dp, qb, db, stat[:, qt, 0, None, :],
                                 stat[:, qt, 1, None, :], _f32_to_bits(stat[:, qt, 2])[:, None, :],
                                 kinfo[:, keys, None], j, thresh, inv)
            gv += rb(pd) @ doh[:, rows]
            gk += rb(ds) @ qh[:, rows]
        dk[:, keys] = gk
        dv[:, keys] = gv
    shape = lambda x: x[:, :T].reshape(B, H, T, d)  # noqa: E731
    return (shape(dq), shape(dk), shape(dv)) + _sum_partials(
        torch.stack((part_k, part_v)), B, H, n_rel)


def _fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return fn


def _f32(t):
    return t.detach().float().contiguous()


def _operand(t):
    """q, k, v or dO as the bf16 backward reads it: bf16 (an f32 operand is
    rounded here), any strides whose rows start 16-byte aligned along a
    unit-stride d."""
    t = t.detach().to(torch.bfloat16)
    if t.stride(-1) != 1 or any(s * 2 % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _table(t):
    """rel_k, rel_v or key_mask as the bf16 forward reads it: f32 or bf16
    (another type is made f32), contiguous."""
    t = t.detach()
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.contiguous()


_FWD_BF16_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 7 + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                                          ctypes.c_void_p])


def _launch_fwd_bf16(q, k, v, rel_k, rel_v, key_mask, seed, rate, window):
    """One launch of the wgmma forward on q, k and v as ``_operand`` hands
    them over (the model's bf16 views, no copy); out and lse share one
    allocation."""
    B, H, T, d = q.shape
    fn = _build.function("rel_attention_train", "rel_attn_train_fwd_bf16", _FWD_BF16_ARGS)
    # an f32 q goes in as q̂ = bf16(q·scale), rounded once as the plain version rounds it
    q_scaled = q.dtype != torch.bfloat16
    if q_scaled:
        q = q.detach().float() * (1.0 / math.sqrt(d))
    ops = [_operand(t) for t in (q, k, v)]
    strides = (ctypes.c_longlong * 12)(*(x for t in ops for x in (*t.stride()[:3], 0)))
    tabs = [_table(t) for t in (rel_k, rel_v, key_mask)]
    flags = sum(1 << i for i, t in enumerate(tabs) if t.dtype == torch.bfloat16)
    n = B * H * T
    res = torch.empty(n * (d + 1), device=q.device)
    out, lse = res[:n * d].view(B, H, T, d), res[n * d:].view(B, H, T)
    status = fn(*(t.data_ptr() for t in ops), ctypes.addressof(strides),
                *(t.data_ptr() for t in tabs), flags, out.data_ptr(), lse.data_ptr(), B, H, T,
                d, rel_k.shape[0], window, int(q_scaled), seed & 0xFFFFFFFF,
                keep_threshold(rate), rate, _stream(q.device))
    _build.check(status, "rel_attention_train bf16 forward")
    return out, lse


def _launch_fwd_f32(q, k, v, rel_k, rel_v, key_mask, seed, rate, window):
    B, H, T, d = q.shape
    args = [_f32(t) for t in (q, k, v, rel_k, rel_v, key_mask)]
    out = torch.empty_like(args[0])
    lse = torch.empty(B, H, T, device=q.device)
    fn = _fn(_build.load("rel_attention_train"), "rel_attn_train_fwd", 8, 6)
    status = fn(*(t.data_ptr() for t in args), out.data_ptr(), lse.data_ptr(), B, H, T, d,
                rel_k.shape[0], window, seed & 0xFFFFFFFF, keep_threshold(rate), rate,
                _stream(q.device))
    _build.check(status, "rel_attention_train forward")
    return out, lse


def _launch_fwd(q, k, v, rel_k, rel_v, key_mask, seed, rate, window, bf16):
    """The forward on the card: with ``bf16`` the wgmma kernel, else the f32
    CUDA-core kernel.  → (out [B, H, T, d], lse [B, H, T]), f32."""
    global fwd_launches
    launch = _launch_fwd_bf16 if bf16 else _launch_fwd_f32
    out, lse = launch(q, k, v, rel_k, rel_v, key_mask, seed, rate, window)
    fwd_launches += 1
    return out, lse


def _sum_partials(parts, B, H, n_rel):
    """The per-tile drel partials [2, B·H, tiles, W, d] (k, then v), summed
    in a fixed order → (drel_k, drel_v) [n_rel, W, d]."""
    W, d = parts.shape[-2:]
    sums = parts.view(2, B, H, -1, W, d).sum(dim=3)
    sums = sums.sum(dim=(1, 2)) if n_rel == 1 else sums.sum(dim=1)
    return tuple(sums.reshape(2, n_rel, W, d))


def _launch_bwd_f32(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate, window):
    B, H, T, d = q.shape
    n_rel, W = rel_k.shape[0], 2 * window + 1
    args = [_f32(t) for t in (q, k, v, rel_k, rel_v, key_mask, out, lse, dout)]
    lib = _build.load("rel_attention_train")
    n_tiles = -(-T // lib.rel_attn_train_tile())
    dq, dk, dv = (torch.empty_like(args[0]) for _ in range(3))
    rowd = torch.empty(B, H, T, device=q.device)             # D = rowsum(dO ∘ O)
    qrel = torch.empty(B, H, T, W, device=q.device)          # q̂·rel_k per row
    dorel = torch.empty_like(qrel)                           # dO·rel_v per row
    parts = torch.empty(2, B * H, n_tiles, W, d, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (B, H, T, d, n_rel, window, seed & 0xFFFFFFFF, keep_threshold(rate), rate, stream)
    fn_q = _fn(lib, "rel_attn_train_bwd_q", 15, 6)
    status = fn_q(*(t.data_ptr() for t in args), dq.data_ptr(), rowd.data_ptr(),
                  qrel.data_ptr(), dorel.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                  *common)
    _build.check(status, "rel_attention_train backward (dq)")
    fn_kv = _fn(lib, "rel_attn_train_bwd_kv", 11, 6)
    status = fn_kv(*(args[i].data_ptr() for i in (0, 1, 2, 5, 7, 8)), rowd.data_ptr(),
                   qrel.data_ptr(), dorel.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common)
    _build.check(status, "rel_attention_train backward (dk, dv)")
    return (dq, dk, dv) + _sum_partials(parts, B, H, n_rel)


_BF16_ARGS = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 7
              + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
_tile_held = None   # the bf16 entry whose library's tile was held to BWD_TILE


def _bwd_bf16_entry():
    """The bf16 backward's entry; the first call on a newly bound library
    holds its tile to ``BWD_TILE``."""
    global _tile_held
    fn = _build.function("rel_attention_train", "rel_attn_train_bwd_bf16", _BF16_ARGS)
    if fn is not _tile_held:
        if _build.function("rel_attention_train", "rel_attn_train_bwd_tile", [])() != BWD_TILE:
            raise RuntimeError("csrc/rel_attention_train.cu's bf16 backward tile is not BWD_TILE")
        _tile_held = fn
    return fn


def _launch_bwd_bf16(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate, window):
    B, H, T, d = q.shape
    BH, n_rel, W = B * H, rel_k.shape[0], 2 * window + 1
    fn = _bwd_bf16_entry()
    Tp, nt = bwd_rows(T)
    # an f32 q goes in as q̂ = bf16(q·scale), rounded once as the plain version rounds it
    q_scaled = q.dtype != torch.bfloat16
    if q_scaled:
        q = q.detach().float() * (1.0 / math.sqrt(d))
    ops = [_operand(t) for t in (q, k, v, dout)]
    strides = (ctypes.c_longlong * 16)(*(x for t in ops for x in (*t.stride()[:3], 0)))
    rest = [_f32(t) for t in (out, lse, key_mask, rel_k, rel_v)]
    dev = q.device
    copies = torch.empty(4, BH * Tp * d, dtype=torch.bfloat16, device=dev)   # qh, kh, vh, doh
    # f32 scratch and outputs in one allocation: stat, band, kinfo, dq, dk, dv, parts
    sizes = (BH * Tp * 3, BH * Tp * BAND_ROW, B * Tp, BH * T * d, BH * T * d, BH * T * d,
             2 * BH * nt * W * d)
    stat, band, kinfo, dq, dk, dv, parts = torch.empty(sum(sizes), device=dev).split(sizes)
    status = fn(*(t.data_ptr() for t in ops), ctypes.addressof(strides),
                *(t.data_ptr() for t in rest), *(c.data_ptr() for c in copies),
                stat.data_ptr(), band.data_ptr(), kinfo.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), parts.data_ptr(), parts[BH * nt * W * d:].data_ptr(),
                B, H, T, d, n_rel, window, int(q_scaled), seed & 0xFFFFFFFF,
                keep_threshold(rate), rate, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "rel_attention_train bf16 backward")
    shape = (B, H, T, d)
    return (dq.view(shape), dk.view(shape), dv.view(shape)) + _sum_partials(
        parts.view(2, BH, nt, W, d), B, H, n_rel)


def _launch_bwd(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate, window, bf16):
    """The backward on the card: with ``bf16`` the wgmma kernels, else the
    f32 CUDA-core kernels.  → (dq, dk, dv, drel_k, drel_v), f32."""
    global bwd_launches
    launch = _launch_bwd_bf16 if bf16 else _launch_bwd_f32
    grads = launch(dout, q, k, v, rel_k, rel_v, key_mask, out, lse, seed, rate, window)
    bwd_launches += 1
    return grads


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
