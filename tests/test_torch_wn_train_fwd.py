"""Kernel E's bf16 forward on wgmma (``csrc/wn_stack_train.cu``, namespace
``wf``), on the CPU: its prepared weights, its constants and grid, and its
data flow written out in plain PyTorch (``wn_stack_train_tiled_fwd``)
against the plain forward.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
``wn_stack_train_tiled_fwd`` is held to ``wn_stack_train_plain_fwd`` with
bf16 operands to 2^-8 of each output's peak: both round the same operands
to bf16, but a gate summed in another order moves some z across a bf16
rounding boundary (one bf16 ulp, 2^-8 of that z), and the residual carry
passes it on to the later layers.  Measured here: at most 1.1e-3 of a
peak, where the plain forward itself moves by up to 9e-4 of its peak
between f32 and f64.  The card tests hold the kernel to 2^-7.
"""

import re

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import wn_stack_train as E

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
    return (t(r.randn(B, T, C)), mask, t(r.randn(B, L, 2 * C) * 0.3),
            t(r.randn(L, K, C, 2 * C) * 0.03), w_rs, b_rs)


def _source():
    return (_build.CSRC / "wn_stack_train.cu").read_text()


def _const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()


def _matrix(block, n):
    """A prepared k block ([n/8][k/8][8 n][8 k]) as its [k, n] matrix."""
    return block.reshape(n // 8, -1, 8, 8).permute(1, 3, 0, 2).reshape(-1, n)


@pytest.mark.parametrize("K", [3, 5])
def test_prepared_weights_invert_to_w_in_and_w_rs(K):
    """``prepare_fwd_weights``' k blocks, read back as wgmma's K-major core
    matrices, give W_in's tanh and sigmoid columns of each chunk for each
    tap, and W_rs's residual and skip halves, in the order the kernel
    streams them; the gate's blocks are bwd_act's."""
    L = 2
    r = np.random.RandomState(K)
    w_in = torch.from_numpy(r.randn(L, K, C, 2 * C).astype(np.float32))
    w_rs = torch.from_numpy(r.randn(L, C, 2 * C).astype(np.float32))
    w = E.prepare_fwd_weights(w_in, w_rs)
    n_gate = 9 * K * E.ACT_BLOCK
    assert w.dtype == torch.bfloat16 and w.shape == (L, n_gate + 12 * E.RS_BLOCK)
    assert w.is_contiguous()
    wi, wr = w_in.bfloat16(), w_rs.bfloat16()
    got_in, got_rs = torch.zeros_like(wi), torch.zeros_like(wr)
    for l in range(L):
        gate = w[l, :n_gate].reshape(3, 3 * K, E.ACT_BLOCK)
        for jc in range(3):
            for tap in range(K):
                for kb in range(3):
                    m = _matrix(gate[jc, 3 * tap + kb], 128)        # [64 k, 128 n]
                    rows = slice(64 * kb, 64 * kb + 64)
                    got_in[l, tap, rows, 64 * jc:64 * jc + 64] = m[:, :64]
                    got_in[l, tap, rows, C + 64 * jc:C + 64 * jc + 64] = m[:, 64:]
        halves = w[l, n_gate:].reshape(2, 6, E.RS_BLOCK)
        for h in range(2):
            for kb in range(6):
                got_rs[l, 32 * kb:32 * kb + 32, C * h:C * h + C] = _matrix(halves[h, kb], C)
    assert torch.equal(got_in, wi) and torch.equal(got_rs, wr)
    act = E.prepare_bwd_weights(w_in, w_rs).act[:, :, :3 * K * E.ACT_BLOCK]
    assert torch.equal(w[:, :n_gate], act.reshape(L, -1))


def test_constants_and_grid_are_the_kernels():
    """The wrapper's constants and ``fwd_grid`` restate
    ``csrc/wn_stack_train.cu``'s: the ring's slots and k blocks, each
    layer's stride in the prepared weights, the launches' grids and
    threads (128 rows a block), and shared memory that fits a block of the
    H100 (227 KB), and two blocks an SM in the 64-row form the ablation tool
    builds (228 KB, 1 KB of it reserved a block)."""
    src = _source()
    assert _const(src, "FWD_SLOT") == "ACT_SLOT" and int(_const(src, "ACT_SLOT")) == E.ACT_BLOCK
    assert _const(src, "RS_BLOCK") == "32 * C" and E.RS_BLOCK == 32 * C
    assert int(_const(src, "PAD")) == E.BF16_MAX_K // 2
    assert _const(src, "EQ") == "C / 4" and _const(src, "SLD") == "EQ + 8"
    tile = src[src.index("struct Tile {"):src.index("};", src.index("struct Tile {"))]
    for line in ("static constexpr int ROWS = 64 * WGS;",
                 "static constexpr int THREADS = 128 * WGS;",
                 "static constexpr int NS = WGS == 2 ? 6 : 3;",
                 "static constexpr int XR = ROWS + 2 * PAD + 1;",
                 "static constexpr int ZR = ROWS + 1;"):
        assert line in tile, line
    launch = src[src.index("cudaError_t launch_layers("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const size_t w_l = (size_t)9 * K * ACT_SLOT + (size_t)C * C2;" in launch
    assert "dim3 rows((T + Tl::ROWS - 1) / Tl::ROWS, B);" in launch
    assert "kernel<<<rows, Tl::THREADS, Tl::SMEM, st>>>" in launch
    assert "wf::launch_layers<FWD_WGS>(" in src
    assert 64 * int(_const(src, "FWD_WGS")) == E.FWD_ROWS == 128
    for wgs, blocks in ((1, 2), (2, 1)):
        rows, ns = 64 * wgs, 6 if wgs == 2 else 3
        xr, zr = rows + 2 * (E.BF16_MAX_K // 2) + 1, rows + 1
        # the window, or the epilogue's two stages; the z tile, the ring, its barriers
        first = max((C // 8) * xr * 16, 2 * rows * (C // 4 + 8) * 4)
        smem = first + ((C // 8) * zr * 8 + ns * E.ACT_BLOCK) * 2 + 2 * ns * 8
        assert smem <= 232448 and blocks * (smem + 1024) <= 233472, wgs
    for B, T in ((1, 1), (2, 77), (12, 640), (12, 896), (12, 1024), (3, 129)):
        assert E.fwd_grid(B, T) == ((-(-T // 128), B), 256)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("T", [77, 150, 256])
def test_tiled_fwd_equals_plain_fwd(T, L, K):
    """The bf16 forward's data flow (windows, prepared k blocks chunk by
    chunk, the two halves, the epilogue) gives the plain bf16 forward's out
    and xs, padded masks and a T that is not a whole number of tiles
    included."""
    args = _inputs(3, T, L, K, seed=T + L)
    want = E.wn_stack_train_plain_fwd(*args, K, True)
    got = E.wn_stack_train_tiled_fwd(*args[:3], E.prepare_fwd_weights(*args[3:5]), args[5], K)
    for name, a, b in zip(("out", "xs"), got, want):
        assert a.shape == b.shape, name
        tol = 2.0 ** -8 * b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)


def test_tiled_fwd_is_not_blind_to_a_misplaced_chunk():
    """A check of the test above: swapping the gate's k blocks of two
    chunks (the same tap and input channels) moves out far past the
    tolerance."""
    T, L, K = 77, 2, 5
    args = _inputs(2, T, L, K, seed=9)
    want, _ = E.wn_stack_train_plain_fwd(*args, K, True)
    w = E.prepare_fwd_weights(*args[3:5])
    n_gate = 9 * K * E.ACT_BLOCK
    gate = w[:, :n_gate].clone().reshape(L, 3, 3 * K, E.ACT_BLOCK)
    gate[:, [0, 1], 0] = gate[:, [1, 0], 0]
    bad = torch.cat([gate.reshape(L, -1), w[:, n_gate:]], dim=1)
    got, _ = E.wn_stack_train_tiled_fwd(*args[:3], bad, args[5], K)
    assert (got - want).abs().max() > 0.05 * want.abs().max()
