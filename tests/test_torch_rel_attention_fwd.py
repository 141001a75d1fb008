"""Kernel F's bf16 forward on wgmma (``csrc/rel_attention_train.cu``,
namespace ``fwd16``), on the CPU: its data flow written out in plain
PyTorch (``relative_self_attention_train_tiled_fwd``) against the plain
forward and the JAX package's Pallas forward, its constants and grid, and
its wrapper handing the model's bf16 operands to the kernel without a copy.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
The tiled forward is held to ``relative_self_attention_train_plain_fwd``
with bf16 operands to 2^-7 of each output's peak, the card tests'
tolerance: both round the same operands to bf16, but the tiled forward
rounds p = exp(s − m) before the online softmax's rescale where the plain
version rounds the normalised p, which agree to one bf16 rounding.  lse is
also held within 1e-3 absolute: its operands are the plain version's, only
the summation order differs, and the backward rebuilds p from it.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispeech_tpu.ops.pallas.flash_attention_train import _fwd as jax_fwd
from vispeech_tpu_torch.ops.kernels import _build
from vispeech_tpu_torch.ops.kernels import rel_attention_train as F


def _inputs(T, n_rel, d, seed=0, B=3, H=2):
    """q, k, v, rel tables and a key mask: batch 0 whole, batch 1 padded by
    37 keys, batch 2 wholly masked."""
    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    mask = t(np.arange(T)[None, :] < np.array([T, T - 37, 0])[:B, None])
    return (t(r.randn(B, H, T, d)), t(r.randn(B, H, T, d)), t(r.randn(B, H, T, d)),
            t(r.randn(n_rel, 9, d) * d ** -0.5), t(r.randn(n_rel, 9, d) * d ** -0.5), mask)


def _held(got, want):
    out, lse = got
    ref, lse_ref = want
    assert out.shape == ref.shape and lse.shape == lse_ref.shape
    for a, b in ((out, ref), (lse, lse_ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -7 * b.abs().max().item())
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_rel", [1, 2])
@pytest.mark.parametrize("T", [77, 128, 200])
def test_tiled_fwd_equals_plain_fwd(T, n_rel, rate, d):
    """The bf16 forward's data flow (64-row q tiles, 64-key tiles, the online
    max and sum, the band's q̂·rel_k, the keep hash, p rounded before its
    rescale, the band's rel_v term from its kept scores once lse is known)
    gives the plain bf16 forward's out and lse, with padded keys, a wholly
    masked batch item and a T that is not a whole number of tiles."""
    args = _inputs(T, n_rel, d, seed=T + n_rel + d)
    want = F.relative_self_attention_train_plain_fwd(*args, 7, rate, 4, True)
    _held(F.relative_self_attention_train_tiled_fwd(*args, 7, rate, 4), want)


def test_tiled_fwd_is_not_blind_to_a_misplaced_tile():
    """A check of the test above: swapping the first two key tiles of the
    bf16 copy of k moves out far past the tolerance."""
    T, d = 131, 96
    args = _inputs(T, 1, d, seed=3)
    ref, _ = F.relative_self_attention_train_plain_fwd(*args, 7, 0.1, 4, True)
    Tp, _ = F.bwd_rows(T)
    kv = [torch.zeros(6, Tp, d) for _ in range(2)]
    for x, src in zip(kv, args[1:3]):
        x[:, :T] = src.reshape(6, T, d).bfloat16().float()
    kv[0] = kv[0][:, torch.cat((torch.arange(64, 128), torch.arange(64), torch.arange(128, Tp)))]
    out, _ = F.relative_self_attention_train_tiled_fwd(*args, 7, 0.1, 4, kv=kv)
    assert (out - ref).abs().max() > 0.1 * ref.abs().max()


def test_tiled_fwd_matches_jax():
    """The same inputs through the JAX package's Pallas forward (interpret
    mode, bf16_compute, rate 0): out on every unpadded row and lse."""
    B, H, T, d = 2, 2, 70, 32
    q, k, v, rel_k, rel_v, mask = _inputs(T, 1, d, seed=5, B=B, H=H)
    out_j, res = jax_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v, rel_k, rel_v, mask)),
                         jnp.float32(0), 0.0, 4, 32, True, True)
    lse_j = torch.from_numpy(np.asarray(res[-1]))[:, :T, 0].reshape(B, H, T)
    out, lse = F.relative_self_attention_train_tiled_fwd(q, k, v, rel_k, rel_v, mask, 0, 0.0, 4)
    out_j = torch.from_numpy(np.asarray(out_j))
    n = T - 37                                # batch 1: rows past its length are padding
    for a, b in ((out[0], out_j[0]), (out[1, :, :n], out_j[1, :, :n])):
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -7 * b.abs().max().item())
    torch.testing.assert_close(lse[:, :, :n], lse_j[:, :, :n], rtol=0, atol=1e-3)


def _source():
    return (_build.CSRC / "rel_attention_train.cu").read_text()


def test_constants_and_grid_are_the_kernels():
    """The tiled forward's constants restate ``csrc/rel_attention_train.cu``'s:
    one warpgroup of 64 query rows a block, blocks over (ceil(T / 64), B·H),
    64-key tiles (the backward's tile)."""
    src = _source()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)  # noqa: E731
    assert int(const("FWD_WGS")) == 1
    assert const("FWD_ROWS") == "BT * FWD_WGS" and const("FWD_THREADS") == "128 * FWD_WGS"
    assert F.FWD_ROWS == 64 * int(const("FWD_WGS")) and F.FWD_KEYS == int(const("BT")) == 64
    assert "const dim3 grid((T + FWD_ROWS - 1) / FWD_ROWS, B * H);" in src
    assert "kernel<<<grid, FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(" in src
    assert "const int qtile = blockIdx.x * FWD_WGS + wg;" in src


def test_bf16_launch_hands_the_operands_on(monkeypatch):
    """The bf16 forward's wrapper makes no f32 copy of q, k or v: the model's
    bf16 [B, T, H, d] projections seen as [B, H, T, d] reach the library
    call as they are, with their strides, and so do bf16 rel tables and key
    mask (flagged bf16); out and lse share one allocation; one call, one
    count.  An f32 q goes in as q̂ = bf16(q·scale) with ``q_scaled``."""
    calls = []

    def function(name, symbol, argtypes):
        assert (name, symbol) == ("rel_attention_train", "rel_attn_train_fwd_bf16")
        assert argtypes == F._FWD_BF16_ARGS
        # the strides live in host memory only for the call: read them there
        strides = F.ctypes.c_longlong * 12
        return lambda *a: calls.append(a + (list(strides.from_address(a[3])),)) or 0

    handed = []
    operand = F._operand
    monkeypatch.setattr(F._build, "function", function)
    monkeypatch.setattr(F, "_operand", lambda t: handed.append(operand(t)) or handed[-1])
    monkeypatch.setattr(F, "_stream", lambda dev: 0)
    B, T, H, d = 2, 50, 2, 96
    q, k, v = (torch.randn(B, T, H, d).bfloat16().transpose(1, 2) for _ in range(3))
    rel_k, rel_v = (torch.randn(1, 9, d).bfloat16() for _ in range(2))
    mask = torch.ones(B, T, dtype=torch.bfloat16)
    before = F.fwd_launches
    out, lse = F._launch_fwd(q, k, v, rel_k, rel_v, mask, 5, 0.1, 4, True)
    assert F.fwd_launches == before + 1 and len(calls) == 1
    a = calls[0]
    assert a[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert a[-1] == [x for t in (q, k, v) for x in (*t.stride()[:3], 0)]
    assert a[4:8] == (rel_k.data_ptr(), rel_v.data_ptr(), mask.data_ptr(), 0b111)
    assert a[8] == out.data_ptr() and a[9] == lse.data_ptr() == out.data_ptr() + out.numel() * 4
    assert out.shape == (B, H, T, d) and lse.shape == (B, H, T) and out.dtype == torch.float32
    assert a[10:17] == (B, H, T, d, 1, 4, 0)
    assert a[17:19] == (5, F.keep_threshold(0.1))

    handed.clear()
    qf = torch.randn(B, H, T, d)
    F._launch_fwd(qf, k, v, rel_k.float(), rel_v, mask.float(), 5, 0.1, 4, True)
    a = calls[1]
    assert a[:3] == tuple(t.data_ptr() for t in handed) and a[1:3] == (k.data_ptr(), v.data_ptr())
    assert torch.equal(handed[0], (qf * (1.0 / math.sqrt(d))).bfloat16())
    assert a[7] == 0b010 and a[16] == 1
