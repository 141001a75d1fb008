"""Kernel E's bf16 backward on wgmma (``csrc/wn_stack_train.cu``, namespace
``wg``), on the CPU: its prepared weights, the tiled layout of its
intermediates, its grid and row splits, and its data flow written out in
plain PyTorch (``wn_stack_train_tiled_bwd``) against the plain backward.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``).
``wn_stack_train_tiled_bwd`` is held to ``wn_stack_train_plain_bwd`` with
bf16 operands to 2^-7 of each tensor's peak, the card tests' tolerance: both
round the same operands to bf16, but sums taken in another order move some
of them across a rounding boundary, and the gradients sum many of them (the
plain backward itself moves by ~1e-3 of the peak between f32 and f64).
"""

import re

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import wn_stack_train as E


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 192


def _inputs(B, T, L, K=5, seed=0):
    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    lengths = np.array([T - 37 * (i % 3) for i in range(B)])
    mask = t((np.arange(T)[None, :] < lengths[:, None])[..., None])
    w_rs = t(r.randn(L, C, 2 * C) * 0.05)
    w_rs[-1, :, C:] = 0.0
    b_rs = t(r.randn(L, 1, 2 * C) * 0.1)
    b_rs[-1, :, C:] = 0.0
    args = (t(r.randn(B, T, C)), mask, t(r.randn(B, L, 2 * C) * 0.3),
            t(r.randn(L, K, C, 2 * C) * 0.03), w_rs, b_rs)
    return args, t(r.randn(B, T, C))


def _source():
    return (_build.CSRC / "wn_stack_train.cu").read_text()


def _const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()


@pytest.mark.parametrize("K", [3, 5])
def test_prepared_weights_invert_to_w_in_and_w_rs(K):
    """``prepare_bwd_weights``' k blocks, read back as wgmma's K-major core
    matrices ([n/8][k/8][8 n][8 k]), give W_in's tanh and sigmoid columns of
    each chunk, W_rs[:, chunk]ᵀ and W_in[tap]ᵀ, in the order the kernels
    stream them."""
    L = 2
    r = np.random.RandomState(K)
    w_in = torch.from_numpy(r.randn(L, K, C, 2 * C).astype(np.float32))
    w_rs = torch.from_numpy(r.randn(L, C, 2 * C).astype(np.float32))
    prep = E.prepare_bwd_weights(w_in, w_rs)
    assert prep.act.dtype == prep.dx.dtype == torch.bfloat16
    assert prep.act.shape == (L, 3, (3 * K + 3) * E.ACT_BLOCK)
    assert prep.dx.shape == (L, K, 6 * E.DX_BLOCK)
    wi, wr = w_in.bfloat16(), w_rs.bfloat16()
    got_in = torch.zeros_like(wi)
    got_rs = torch.zeros_like(wr)
    got_in_t = torch.zeros_like(wi)

    def matrix(block, n):   # [n/8][k/8][8 n][8 k] → B[k][n]
        return block.reshape(n // 8, -1, 8, 8).permute(1, 3, 0, 2).reshape(-1, n)

    for l in range(L):
        for jc in range(3):
            blocks = prep.act[l, jc].reshape(3 * K + 3, E.ACT_BLOCK)
            for tap in range(K):
                for kb in range(3):
                    m = matrix(blocks[3 * tap + kb], 128)          # [64 k, 128 n]
                    rows = slice(64 * kb, 64 * kb + 64)
                    got_in[l, tap, rows, 64 * jc:64 * jc + 64] = m[:, :64]
                    got_in[l, tap, rows, C + 64 * jc:C + 64 * jc + 64] = m[:, 64:]
            for kb in range(3):
                m = matrix(blocks[3 * K + kb], 64)                  # [128 k, 64 n]
                got_rs[l, 64 * jc:64 * jc + 64, 128 * kb:128 * kb + 128] = m.t()
        for tap in range(K):
            blocks = prep.dx[l, tap].reshape(6, E.DX_BLOCK)
            for kb in range(6):
                m = matrix(blocks[kb], C)                           # [64 k, 192 n]
                got_in_t[l, tap, :, 64 * kb:64 * kb + 64] = m.t()
    assert torch.equal(got_in, wi) and torch.equal(got_rs, wr) and torch.equal(got_in_t, wi)


def test_constants_and_grid_are_the_kernels():
    """The wrapper's constants and ``bwd_grid`` restate
    ``csrc/wn_stack_train.cu``'s: tiles, halo rows, stage rows, splits, k
    blocks and the launches' grids; the splits cover every (batch item,
    WGRAD_ROWS) item once, in order, and the weight-gradient grid fits one
    wave of the 132 SMs."""
    src = _source()
    for name, value in (("TR", E.TILE_ROWS), ("HP", E.HALO_ROWS), ("RK", E.WGRAD_ROWS),
                        ("WGRAD_SPLITS", E.WGRAD_SPLITS_BF16), ("PAD", E.BF16_MAX_K // 2),
                        ("ACT_SLOT", E.ACT_BLOCK), ("TAPG", E.WGRAD_GROUP)):
        assert int(_const(src, name)) == value, name
    assert _const(src, "DX_SLOT") == "64 * C" and E.DX_BLOCK == 64 * C
    assert "const int tiles = (T + wg::TR - 1) / wg::TR, n_rk = tiles * (wg::TR / wg::RK);" in src
    assert "dim3 rows(tiles, B);" in src
    assert "dim3 wgrid((K + wg::TAPG) / wg::TAPG * (C / 64), C2 / 128, wg::WGRAD_SPLITS);" in src
    assert "act_kernel<<<rows, wg::ACT_NT" in src and "dx_kernel<<<rows, wg::NT" in src
    assert "wgrad_kernel<<<wgrid, wg::WG_NT" in src
    assert "constexpr int WG_NT = TAPG * 128 + 128;" in src
    assert "constexpr int NT = NCT + 32;" in src
    assert "constexpr int ACT_NT = NT + ACT_LOADERS;" in src
    assert int(_const(src, "ACT_LOADERS")) == 96
    for B, T in ((1, 1), (2, 77), (12, 640), (12, 1000), (12, 1024), (3, 129)):
        grid = E.bwd_grid(B, T, 5)
        Tr, Tp = E.tiled_rows(T)
        assert Tr % E.TILE_ROWS == 0 and Tr - E.TILE_ROWS < T <= Tr and Tp == Tr + 16
        assert grid["act"] == ((Tr // E.TILE_ROWS, B), 384)
        assert grid["dx"] == ((Tr // E.TILE_ROWS, B), 288)
        assert grid["wgrad"] == ((6, 3, 7), 4 * 128)
        assert E.bwd_grid(B, T, 3)["wgrad"][0] == (6, 3, 7)
        assert 6 * 3 * E.WGRAD_SPLITS_BF16 <= 132
        splits = grid["splits"]
        assert len(splits) == E.WGRAD_SPLITS_BF16 and splits[0][0] == 0
        assert splits[-1][1] == B * Tr // E.WGRAD_ROWS
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(splits, splits[1:]))


@pytest.mark.parametrize("T", [1, 77, 128, 300])
def test_tiled_layout_round_trip(T):
    """``to_tiled`` puts row t of chunk j at HALO_ROWS + t, zeros elsewhere;
    ``from_tiled`` reads it back, shifted windows with zeros past the edges."""
    x = torch.randn(2, T, 16)
    Tr, Tp = E.tiled_rows(T)
    tl = E.to_tiled(x, Tp)
    assert tl.shape == (2, 2, Tp, 8)
    assert torch.equal(tl[0, 1, E.HALO_ROWS + T - 1], x[0, T - 1, 8:])
    assert tl[:, :, :E.HALO_ROWS].abs().sum() == 0 and tl[:, :, E.HALO_ROWS + T:].abs().sum() == 0
    assert torch.equal(E.from_tiled(tl, T), x)
    for shift in (-2, -1, 1, 2):
        want = torch.zeros_like(x)
        lo, hi = max(0, -shift), min(T, T - shift)
        if hi > lo:
            want[:, lo:hi] = x[:, lo + shift:hi + shift]
        assert torch.equal(E.from_tiled(tl, T, shift), want)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("T,L", [(77, 1), (150, 3), (256, 2)])
def test_tiled_bwd_equals_plain_bwd(T, L, K):
    """The bf16 backward's data flow (tiled bf16 intermediates, prepared k
    blocks, row splits) gives the plain bf16 backward's gradients, padded
    masks and a T that is not a whole number of tiles included."""
    args, dout = _inputs(3, T, L, K, seed=T + L)
    _, xs = E.wn_stack_train_plain_fwd(*args, K, True)
    want = E.wn_stack_train_plain_bwd(dout, xs, *args[1:5], K, True)
    got = E.wn_stack_train_tiled_bwd(dout, xs, *args[1:3],
                                     E.prepare_bwd_weights(*args[3:5]), K)
    for name, a, b in zip(("dx", "dcond", "dw_in", "dw_rs", "db_rs"), got, want):
        assert a.shape == b.shape, name
        tol = 2.0 ** -7 * b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)


def test_tiled_bwd_is_not_blind_to_a_misplaced_block():
    """A check of the test above: swapping two of the prepared k blocks
    (one tap for another) moves every gradient far past the tolerance."""
    T, L, K = 77, 1, 5
    args, dout = _inputs(2, T, L, K, seed=9)
    _, xs = E.wn_stack_train_plain_fwd(*args, K, True)
    want = E.wn_stack_train_plain_bwd(dout, xs, *args[1:5], K, True)
    prep = E.prepare_bwd_weights(*args[3:5])
    act = prep.act.clone().reshape(L, 3, 3 * K + 3, E.ACT_BLOCK)
    act[:, :, [0, 3]] = act[:, :, [3, 0]]
    bad = E.BwdWeights(act.reshape(prep.act.shape), prep.dx)
    got = E.wn_stack_train_tiled_bwd(dout, xs, *args[1:3], bad, K)
    dx, ref = got[0], want[0]
    assert (dx - ref).abs().max() > 0.1 * ref.abs().max()
