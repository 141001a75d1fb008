"""Kernels E and F of the port (``wn_stack_train``, ``rel_attention_train``)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On a CPU tensor each wrapper runs its plain forward and its plain backward
(the TPU kernel's backward formulas written out, not autograd of the
forward), so these tests pin the arithmetic the CUDA kernels are held to on
the card.  Inputs come from numpy seeds and go to both sides.

Tolerances: f32 to 2e-5 absolute on values of order 1 (summation order);
``bf16_compute`` to 2e-2 of each tensor's peak: both sides round the same
operands to bf16, but a different summation order can move an operand
across a rounding boundary (2^-8 relative), and gradients sum many of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispeech_tpu.ops.pallas.flash_attention_train import relative_self_attention_train
from vispeech_tpu.ops.pallas.wn_stack_train import wn_stack_train
from vispeech_tpu_torch.ops.kernels import rel_attention, rel_attention_train as F_
from vispeech_tpu_torch.ops.kernels import wn_stack_train as E_

F32_ATOL = 2e-5
BF16_REL = 2e-2


def _close(got, want, bf16, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if bf16:
        tol = BF16_REL * max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=F32_ATOL, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------- kernel E

def wn_inputs(B=2, T=21, C=16, L=3, k=5, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, T, C).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.array([T, T - 6])[:, None, None]).astype(np.float32)
    cond = (r.randn(B, L, 2 * C) * 0.3).astype(np.float32)
    w_in = (r.randn(L, k, C, 2 * C) * 0.2).astype(np.float32)
    w_rs = (r.randn(L, C, 2 * C) * 0.2).astype(np.float32)
    w_rs[L - 1, :, C:] = 0.0   # the last layer's skip half is packed as zeros
    b_rs = (r.randn(L, 1, 2 * C) * 0.1).astype(np.float32)
    b_rs[L - 1, :, C:] = 0.0
    dout = r.randn(B, T, C).astype(np.float32)
    return (x, mask, cond, w_in, w_rs, b_rs), k, dout


@pytest.mark.parametrize("bf16", [False, True])
def test_wn_stack_train_matches_jax(bf16):
    arrays, k, dout = wn_inputs()
    out_j, vjp = jax.vjp(
        lambda x, c, wi, wr, br: wn_stack_train(x, jnp.asarray(arrays[1]), c, wi, wr, br, k,
                                                interpret=True, bf16_compute=bf16),
        *(jnp.asarray(arrays[i]) for i in (0, 2, 3, 4, 5)))
    grads_j = vjp(jnp.asarray(dout))

    ts = [_t(a) for a in arrays]
    for i in (0, 2, 3, 4, 5):
        ts[i].requires_grad_(True)
    out = E_.wn_stack_train(*ts, k, bf16_compute=bf16)
    out.backward(_t(dout))
    _close(out.detach(), out_j, bf16, "out")
    for i, g in zip((0, 2, 3, 4, 5), grads_j):
        _close(ts[i].grad, g, bf16, f"grad {i}")


def test_wn_stack_train_plain_bwd_is_the_gradient_of_the_plain_fwd():
    arrays, k, dout = wn_inputs(seed=1)
    ts = [_t(a).double() for a in arrays]
    for i in (0, 2, 3, 4, 5):
        ts[i].requires_grad_(True)
    out, xs = E_.wn_stack_train_plain_fwd(*ts, k)
    out.backward(_t(dout).double())
    got = E_.wn_stack_train_plain_bwd(_t(dout).double(), xs.detach(), ts[1],
                                      *(t.detach() for t in (ts[2], ts[3], ts[4])), k)
    for g, i in zip(got, (0, 2, 3, 4, 5)):
        torch.testing.assert_close(g, ts[i].grad, rtol=1e-10, atol=1e-10)


def test_wn_stack_train_forward_is_kernel_b():
    from vispeech_tpu_torch.ops.kernels import wn_stack

    arrays, k, _ = wn_inputs(seed=2)
    ts = [_t(a) for a in arrays]
    out, _ = E_.wn_stack_train_plain_fwd(*ts, k)
    torch.testing.assert_close(out, wn_stack.wn_stack_plain(*ts, k), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- kernel F

def attn_inputs(n_rel, B=2, H=2, T=19, d=16, seed=0):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, H, T, d).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((r.randn(n_rel, 9, d) * d ** -0.5).astype(np.float32) for _ in range(2))
    mask = (np.arange(T)[None, :] < np.array([T, T - 7])[:, None]).astype(np.float32)
    dout = r.randn(B, H, T, d).astype(np.float32)
    return (q, k, v, rel_k, rel_v, mask), dout


@pytest.mark.parametrize("n_rel,bf16", [(1, False), (2, False), (1, True)])
def test_rel_attention_train_matches_jax(n_rel, bf16):
    arrays, dout = attn_inputs(n_rel)
    mask_j = jnp.asarray(arrays[5])
    out_j, vjp = jax.vjp(
        lambda q, k, v, rk, rv: relative_self_attention_train(
            q, k, v, rk, rv, mask_j, jnp.float32(0), 0.0, window=4, block_q=8,
            interpret=True, bf16_compute=bf16),
        *(jnp.asarray(a) for a in arrays[:5]))
    grads_j = vjp(jnp.asarray(dout))

    ts = [_t(a) for a in arrays]
    for t in ts[:5]:
        t.requires_grad_(True)
    out = F_.relative_self_attention_train(*ts, seed=0, rate=0.0, bf16_compute=bf16)
    out.backward(_t(dout))
    n = arrays[5][1].sum().astype(int)   # batch 1: rows past its length are padding
    _close(out.detach()[0], out_j[0], bf16, "out")
    _close(out.detach()[1, :, :n], out_j[1, :, :n], bf16, "out (padded batch)")
    for t, g, name in zip(ts[:5], grads_j, ("dq", "dk", "dv", "drel_k", "drel_v")):
        _close(t.grad, g, bf16, name)


def test_rel_attention_train_padded_keys_get_zero_grad():
    arrays, dout = attn_inputs(1, seed=3)
    ts = [_t(a) for a in arrays]
    for t in ts[:3]:
        t.requires_grad_(True)
    F_.relative_self_attention_train(*ts, seed=5, rate=0.2).backward(_t(dout))
    n = int(arrays[5][1].sum())
    assert ts[1].grad[1, :, n:].abs().max() == 0 and ts[2].grad[1, :, n:].abs().max() == 0


def test_dropout_plain_bwd_uses_the_forward_mask():
    """The plain backward regenerates the keep mask from the seed; if it
    drew another mask its gradients would differ from autograd through the
    plain forward (which keeps the forward's mask)."""
    arrays, dout = attn_inputs(2, seed=4)
    ts = [_t(a).double() for a in arrays]
    for t in ts[:5]:
        t.requires_grad_(True)
    out, lse = F_.relative_self_attention_train_plain_fwd(*ts, seed=77, rate=0.3)
    out.backward(_t(dout).double())
    got = F_.relative_self_attention_train_plain_bwd(
        _t(dout).double(), *(t.detach() for t in ts), lse.detach(), seed=77, rate=0.3)
    for g, t, name in zip(got, ts[:5], ("dq", "dk", "dv", "drel_k", "drel_v")):
        torch.testing.assert_close(g, t.grad, rtol=1e-9, atol=1e-9, msg=name)


def test_dropout_keep_share_and_hash():
    rate, B, H, T = 0.1, 4, 2, 128
    keep = F_.dropout_keep(1234, rate, B, H, T)
    n = keep.numel()
    share = keep.double().mean().item()
    assert abs(share - (1 - rate)) <= 3 * (rate * (1 - rate) / n) ** 0.5
    assert not torch.equal(keep, F_.dropout_keep(1235, rate, B, H, T))
    # the limb arithmetic equals true uint32 arithmetic
    h = torch.tensor([0, 1, 0xFFFFFFFF, 0x12345678, 0xDEADBEEF], dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1):
        want = [(int(v) * c) % 2 ** 32 for v in h]
        assert F_._mul32(h, c).tolist() == want


def test_rate_zero_is_kernel_a():
    arrays, _ = attn_inputs(1, seed=6)
    ts = [_t(a) for a in arrays]
    out, _ = F_.relative_self_attention_train_plain_fwd(*ts, seed=3, rate=0.0)
    torch.testing.assert_close(out, rel_attention.relative_self_attention_plain(*ts),
                               rtol=0, atol=1e-6)
