"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is off for the plain versions.  f32 tolerances cover summation order,
and for kernel B also its 3-pass TF32 split (each product to ~2^-21
relative, the tensor cores' f32 accumulation) over 960-term sums: 5e-5 on
outputs of order 1.  bf16 output is held to 2^-7 of its peak, one bf16 ulp
in the peak's binade.  The training kernels E and F, forward and every
gradient, are held to 1e-4 of each tensor's peak in f32 and 2^-7 of it
with bf16 operands.
"""

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.ops.kernels import mrf_stage, rel_attention, wn_stack
from vispeech_tpu_torch.ops.kernels import rel_attention_train, wn_stack_train

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = saved


def _cuda(device, *arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_rel,d", [(300, 1, 96), (1400, 1, 96), (129, 2, 64)])
def test_rel_attention(device, T, n_rel, d):
    r = np.random.RandomState(0)
    n = T - 89
    q, k, v = (r.randn(2, 2, T, d) for _ in range(3))
    rel_k, rel_v = (r.randn(n_rel, 9, d) * d ** -0.5 for _ in range(2))
    mask = (np.arange(T)[None, :] < np.array([T, n])[:, None]).astype(np.float32)
    args = _cuda(device, q, k, v, rel_k, rel_v, mask)
    before = rel_attention.launches
    out = rel_attention.relative_self_attention(*args)
    ref = rel_attention.relative_self_attention_plain(*args)
    assert rel_attention.launches == before + 1
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(out[1, :, :n], ref[1, :, :n], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_rel_attention_fully_masked_row_finite(device):
    r = np.random.RandomState(1)
    q = r.randn(1, 2, 64, 96)
    args = _cuda(device, q, q, q, np.zeros((1, 9, 96)), np.zeros((1, 9, 96)),
                 np.zeros((1, 64)))
    assert torch.isfinite(rel_attention.relative_self_attention(*args)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [37, 1400])
def test_wn_stack(device, T):
    r = np.random.RandomState(2)
    B, C, L, K = 2, 192, 4, 5
    mask = (np.arange(T)[None, :] < np.array([T, T // 2])[:, None])[..., None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.1,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, r.randn(L, 1, 2 * C) * 0.1)
    before = wn_stack.launches
    out = wn_stack.wn_stack(*args, K)
    assert wn_stack.launches == before + 1
    torch.testing.assert_close(out, wn_stack.wn_stack_plain(*args, K), rtol=0, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [100, 700])
def test_mrf_stage(device, dtype, T):
    r = np.random.RandomState(3)
    C = 64
    x = _cuda(device, r.randn(2, T, C), dtype=dtype)[0]
    packed = [_cuda(device, r.randn(3, k, C, C) * 0.03, r.randn(3, 1, C) * 0.1,
                    r.randn(3, k, C, C) * 0.03, r.randn(3, 1, C) * 0.1) for k in KS]
    before = mrf_stage.launches
    out = mrf_stage.mrf_stack(x, packed, KS, DILS)
    assert mrf_stage.launches == before + 1 and out.dtype == dtype
    ref = mrf_stage.mrf_stack_plain(x, packed, KS, DILS).float()
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max().item()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.zeros(1, 10, 32, device=device)
    with pytest.raises(ValueError, match="C = 64"):
        mrf_stage.mrf_stack(x, [], KS, DILS)
    q = torch.zeros(1, 1, 10, 48, device=device)
    rel = torch.zeros(1, 9, 48, device=device)
    with pytest.raises(ValueError, match="d in"):
        rel_attention.relative_self_attention(q, q, q, rel, rel,
                                              torch.ones(1, 10, device=device))


def _held(got, want, bf16):
    for a, b in zip(got, want):
        tol = (2.0 ** -7 if bf16 else 1e-4) * b.abs().max().item()
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bf16", [(3, False), (16, False), (4, True)])
def test_wn_stack_train(device, L, bf16):
    r = np.random.RandomState(4)
    B, T, C, K = 2, 77, 192, 5
    mask = (np.arange(T)[None, :] < np.array([T, T - 20])[:, None])[..., None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    b_rs = r.randn(L, 1, 2 * C) * 0.1
    b_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.3,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, b_rs)
    dout = _cuda(device, r.randn(B, T, C))[0]
    leaves = [a.clone().requires_grad_(i != 1) for i, a in enumerate(args)]
    before = (wn_stack_train.fwd_launches, wn_stack_train.bwd_launches)
    out = wn_stack_train.wn_stack_train(*leaves, K, bf16_compute=bf16)
    out.backward(dout)
    assert (wn_stack_train.fwd_launches, wn_stack_train.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref, xs = wn_stack_train.wn_stack_train_plain_fwd(*args, K, bf16)
    refs = wn_stack_train.wn_stack_train_plain_bwd(dout, xs, *args[1:5], K, bf16)
    _held([out] + [leaves[i].grad for i in (0, 2, 3, 4, 5)], (ref,) + refs, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_rel,rate,bf16", [(131, 1, 0.1, False), (64, 2, 0.0, False),
                                               (300, 1, 0.1, True)])
def test_rel_attention_train(device, T, n_rel, rate, bf16):
    r = np.random.RandomState(5)
    B, H, d = 2, 2, 96
    mask = (np.arange(T)[None, :] < np.array([T, T - 37])[:, None]).astype(np.float32)
    args = _cuda(device, r.randn(B, H, T, d), r.randn(B, H, T, d), r.randn(B, H, T, d),
                 r.randn(n_rel, 9, d) * d ** -0.5, r.randn(n_rel, 9, d) * d ** -0.5, mask)
    dout = _cuda(device, r.randn(B, H, T, d))[0]
    leaves = [a.clone().requires_grad_(i < 5) for i, a in enumerate(args)]
    out = rel_attention_train.relative_self_attention_train(*leaves, 11, rate,
                                                            bf16_compute=bf16)
    out.backward(dout)
    ref, lse = rel_attention_train.relative_self_attention_train_plain_fwd(*args, 11, rate, 4,
                                                                           bf16)
    refs = rel_attention_train.relative_self_attention_train_plain_bwd(
        dout, *args, lse, 11, rate, 4, bf16)
    _held([out] + [leaves[i].grad for i in range(5)], (ref,) + refs, bf16)
    n = T - 37   # padded key columns get no gradient
    assert leaves[1].grad[1, :, n:].abs().max() == 0 and leaves[2].grad[1, :, n:].abs().max() == 0


@pytest.mark.cuda
def test_inference_kernels_refuse_autograd_on_the_card(device):
    x = torch.zeros(1, 10, 64, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage.mrf_stack(x, [], KS, DILS)
    q = torch.zeros(1, 2, 10, 96, device=device, requires_grad=True)
    rel = torch.zeros(1, 9, 96, device=device)
    with pytest.raises(RuntimeError, match="rel_attention_train"):
        rel_attention.relative_self_attention(q, q, q, rel, rel, torch.ones(1, 10, device=device))
    with torch.no_grad():
        rel_attention.relative_self_attention(q, q, q, rel, rel, torch.ones(1, 10, device=device))
