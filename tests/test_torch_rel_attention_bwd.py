"""Kernel F's bf16 backward on wgmma (``csrc/rel_attention_train.cu``,
namespace ``bwd16``), on the CPU: what its prep kernel writes, the tiled
layout of its bf16 copies, its tile constants and grid, and its data flow
written out in plain PyTorch (``relative_self_attention_train_tiled_bwd``)
against the plain backward.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``).
The tiled backward is held to ``relative_self_attention_train_plain_bwd``
with bf16 operands to 2^-7 of each gradient's peak, the card tests'
tolerance: both round the same operands to bf16, but the kernels take
D = rowsum(dO ∘ O) where the plain version sums dp ∘ p, and sums taken in
another order move some bf16 roundings of ds and pd.
"""

import math
import re

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import rel_attention_train as F

D_HEAD = 96


def _inputs(T, n_rel, seed=0, B=2, H=2, d=D_HEAD):
    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    mask = t(np.arange(T)[None, :] < np.array([T, T - 37])[:B, None])
    args = (t(r.randn(B, H, T, d)), t(r.randn(B, H, T, d)), t(r.randn(B, H, T, d)),
            t(r.randn(n_rel, 9, d) * d ** -0.5), t(r.randn(n_rel, 9, d) * d ** -0.5), mask)
    return args, t(r.randn(B, H, T, d))


def _source():
    return (_build.CSRC / "rel_attention_train.cu").read_text()


def _const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_rel", [1, 2])
@pytest.mark.parametrize("T", [64, 131, 300])
def test_tiled_bwd_equals_plain_bwd(T, n_rel, rate):
    """The bf16 backward's data flow (tiled bf16 copies, the q pass with its
    band partials, the transposed kv pass, the partials summed in order)
    gives the plain bf16 backward's gradients, padded keys and a T that is
    not a whole number of tiles included."""
    args, dout = _inputs(T, n_rel, seed=T + n_rel)
    out, lse = F.relative_self_attention_train_plain_fwd(*args, 7, rate, 4, True)
    want = F.relative_self_attention_train_plain_bwd(dout, *args, lse, 7, rate, 4, True)
    got = F.relative_self_attention_train_tiled_bwd(dout, *args, out, lse, 7, rate, 4)
    for name, a, b in zip(("dq", "dk", "dv", "drel_k", "drel_v"), got, want):
        assert a.shape == b.shape, name
        tol = 2.0 ** -7 * b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)
    n = T - 37   # padded keys get exactly zero dk and dv
    assert got[1][1, :, n:].abs().max() == 0 and got[2][1, :, n:].abs().max() == 0


def test_tiled_bwd_is_not_blind_to_a_misplaced_tile():
    """A check of the test above: swapping two key tiles of the bf16 copy of
    k moves dq far past the tolerance."""
    T = 131
    args, dout = _inputs(T, 1, seed=3)
    out, lse = F.relative_self_attention_train_plain_fwd(*args, 7, 0.1, 4, True)
    want = F.relative_self_attention_train_plain_bwd(dout, *args, lse, 7, 0.1, 4, True)
    prep = F.bwd_prep(dout, *args, out, lse, 7, 4)
    prep["kh"] = prep["kh"][:, [1, 0, 2]].contiguous()
    got = F.relative_self_attention_train_tiled_bwd(dout, *args, out, lse, 7, 0.1, 4, prep=prep)
    assert (got[0] - want[0]).abs().max() > 0.1 * want[0].abs().max()


def test_constants_and_grid_are_the_kernels():
    """The wrapper's tile and band constants and ``bwd_grid`` restate
    ``csrc/rel_attention_train.cu``'s: 64-row tiles of one warpgroup, one
    prep launch and one launch of both passes over (tiles, B·H), the q pass
    at z = 0 and the kv pass at z = 1."""
    src = _source()
    assert int(_const(src, "BT")) == F.BWD_TILE == 64
    assert int(_const(src, "NT")) == 128
    assert _const(src, "BAND") == "2 * MAXW" and int(_const(src, "MAXW")) == F._MAXW == 9
    assert F.BAND_ROW == 2 * F._MAXW
    assert int(_const(src, "BQ")) == 32   # the forward's and the f32 backward's tile
    assert "const dim3 grid(Tp / BT, B * H);" in src
    assert "prep_kernel<D><<<grid, NT, 0, s>>>" in src
    assert "qkv<<<dim3(grid.x, grid.y, 2), NT, QKV_SMEM<D>, s>>>" in src
    assert "if (blockIdx.z == 0)\n    q_pass<D, DROP>" in src
    for B, H, T in ((1, 2, 1), (12, 2, 128), (12, 2, 640), (12, 2, 1024), (2, 2, 131)):
        Tp, nt = F.bwd_rows(T)
        assert Tp % 64 == 0 and Tp - 64 < T <= Tp and nt == Tp // 64
        grid = F.bwd_grid(B, H, T)
        assert grid == {"prep": ((nt, B * H), 128), "qkv": ((nt, B * H, 2), 128)}


@pytest.mark.parametrize("T", [1, 64, 131])
def test_tiled_layout_round_trip(T):
    """``to_bwd_tiles`` puts row t, column c of a batch-head at tile t // 64,
    chunk c // 8, row t % 64, lane c % 8, zero past T; ``from_bwd_tiles``
    reads it back."""
    x = torch.randn(3, T, D_HEAD).bfloat16().float()
    Tp, nt = F.bwd_rows(T)
    tl = F.to_bwd_tiles(x, Tp)
    assert tl.shape == (3, nt, D_HEAD // 8, 64, 8) and tl.dtype == torch.bfloat16
    t, c = T - 1, 77
    assert tl[2, t // 64, c // 8, t % 64, c % 8] == x[2, t, c]
    back = F.from_bwd_tiles(tl)
    assert torch.equal(back[:, :T], x) and back[:, T:].abs().sum() == 0


@pytest.mark.parametrize("n_rel", [1, 2])
def test_prep_holds_the_rows_definitions(n_rel):
    """``bwd_prep``: q̂ rounded once as bf16(q·scale); lse with +inf past T;
    D = rowsum(dO ∘ O); the row keys from which ``dropout_keep`` hashes its
    columns; q̂·rel_k and dO·rel_v over bf16 operands, zero for unused band
    slots; kinfo 1, 0 or −1."""
    T, B, H, d = 70, 2, 2, D_HEAD
    args, dout = _inputs(T, n_rel, seed=11)
    q, k, v, rel_k, rel_v, mask = args = args[:3] + (args[3][:, 2:7], args[4][:, 2:7], args[5])
    out, lse = F.relative_self_attention_train_plain_fwd(*args, 5, 0.1, 2, True)
    prep = F.bwd_prep(dout, *args, out, lse, 5, 2)
    Tp, nt = F.bwd_rows(T)
    qs = F.from_bwd_tiles(prep["qh"]).reshape(B, H, Tp, d)
    assert torch.equal(qs[:, :, :T], (q * (1.0 / math.sqrt(d))).bfloat16().float())
    stat = prep["stat"].transpose(2, 3).reshape(B, H, Tp, 3)
    assert torch.equal(stat[:, :, :T, 0], lse) and torch.isinf(stat[:, :, T:, 0]).all()
    torch.testing.assert_close(stat[:, :, :T, 1], (dout.bfloat16().float() * out).sum(-1),
                               rtol=1e-6, atol=1e-5)
    rk = F._f32_to_bits(stat[..., 2])
    col = F._mul32(torch.arange(T, dtype=torch.int64) + 1, F._K_COL)
    keep = F._fmix32(rk[:, :, :T, None] ^ col) >= F.keep_threshold(0.1)
    assert torch.equal(keep, F.dropout_keep(5, 0.1, B, H, T))
    band = prep["band"].reshape(B, H, Tp, F.BAND_ROW)
    rel = rel_k.bfloat16().float().expand(H, -1, -1)
    want = torch.einsum("bhtd,hwd->bhtw", qs[:, :, :T], rel)
    torch.testing.assert_close(band[:, :, :T, :5], want, rtol=1e-6, atol=1e-5)
    assert band[..., 5:9].abs().sum() == 0 and band[..., 14:].abs().sum() == 0
    kinfo = prep["kinfo"]
    assert torch.equal(kinfo[:, :T], (mask > 0).float()) and (kinfo[:, T:] == -1).all()


@pytest.mark.parametrize("n_rel", [1, 2])
def test_partials_sum_in_a_fixed_order(n_rel):
    """``_sum_partials`` adds the per-tile partials over tiles, then over
    batch and (shared tables) heads: the sums the plain backward takes."""
    B, H, nt, W, d = 3, 2, 4, 9, 8
    parts = torch.randn(2, B * H, nt, W, d, dtype=torch.float64)
    drel_k, drel_v = F._sum_partials(parts, B, H, n_rel)
    per_head = parts.reshape(2, B, H, nt, W, d).sum(dim=(1, 3))
    want = per_head.sum(dim=1, keepdim=True) if n_rel == 1 else per_head
    assert drel_k.shape == drel_v.shape == (n_rel, W, d)
    torch.testing.assert_close(torch.stack((drel_k, drel_v)), want)


def test_operands_keep_aligned_strided_views():
    """The kernels read bf16 q, k, v and dO through their strides: the
    model's [B, T, H, d] projections seen as [B, H, T, d] go in without a
    copy; an f32 operand is rounded to bf16; a view whose rows do not start
    16-byte aligned, or whose d is strided, is copied."""
    x = torch.randn(2, 50, 2, D_HEAD).bfloat16()
    view = x.transpose(1, 2)
    assert F._operand(view).data_ptr() == view.data_ptr()
    f32 = view.float()
    assert torch.equal(F._operand(f32), view) and F._operand(f32).dtype == torch.bfloat16
    odd = torch.randn(2 * 50 * 2 * D_HEAD + 1).bfloat16()[1:].view(2, 2, 50, D_HEAD)
    got = F._operand(odd)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
    strided = torch.randn(2, 2, 50, 2 * D_HEAD).bfloat16()[..., ::2]
    got = F._operand(strided)
    assert got.stride(-1) == 1 and torch.equal(got, strided)


def test_bwd_entry_holds_the_tile_once_per_library(monkeypatch):
    """``_bwd_bf16_entry`` asks the library for its tile on the first call
    after a library is bound (the ablation tool binds a new one per variant),
    not on every backward, and refuses a library whose tile is not
    ``BWD_TILE``."""
    asked, tile, bound = [], [F.BWD_TILE], [object()]

    def function(name, symbol, argtypes):
        if symbol == "rel_attn_train_bwd_tile":
            return lambda: asked.append(symbol) or tile[0]
        return bound[0]

    monkeypatch.setattr(F._build, "function", function)
    monkeypatch.setattr(F, "_tile_held", None)
    first = bound[0]
    assert F._bwd_bf16_entry() is first and F._bwd_bf16_entry() is first
    assert len(asked) == 1
    bound[0] = object()
    assert F._bwd_bf16_entry() is bound[0] and len(asked) == 2
    bound[0], tile[0] = object(), 32
    with pytest.raises(RuntimeError, match="BWD_TILE"):
        F._bwd_bf16_entry()
