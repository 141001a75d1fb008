"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

TF32 is off for the plain versions.  f32 tolerances cover summation order
(kernel A's key splits and merge included),
and for kernel B also its 3-pass TF32 split (each product to ~2^-21
relative, the tensor cores' f32 accumulation) over 960-term sums: 5e-5 on
outputs of order 1, and 1e-4 of the peak over kernel B's 16 per-layer
launches.  Kernel D in f32 is held to 1e-4 of its output's peak (sums of
up to 15 · 128 terms).  bf16 output is held to 2^-7 of its peak, one bf16
ulp in the peak's binade.  The training kernels E and F, forward and every
gradient, are held to 1e-4 of each tensor's peak in f32 and 2^-7 of it
with bf16 operands (E's and F's bf16 kernels on wgmma included); F's bf16
forward's lse also within 1e-3 absolute, since the backward rebuilds p
from it.
"""

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.ops.kernels import mrf_stage, mrf_stage_folded, rel_attention, wn_stack
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
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("T", [17, 32, 96, 129, 512, 1400])
def test_rel_attention_key_splits(device, T, B):
    """One and several key splits (``key_splits``), q, k, v given as the
    projections' [B, H, T, d] views of [B, T, H, d] tensors."""
    r = np.random.RandomState(8)
    H, d = 2, 96
    lengths = [T, max(T - 37, 1)][:B]
    q, k, v = (torch.from_numpy(r.randn(B, T, H, d).astype(np.float32)).to(device)
               .transpose(1, 2) for _ in range(3))
    rel_k, rel_v, mask = _cuda(device, r.randn(1, 9, d) * d ** -0.5, r.randn(1, 9, d) * d ** -0.5,
                               np.arange(T)[None, :] < np.array(lengths)[:, None])
    before = rel_attention.launches
    out = rel_attention.relative_self_attention(q, k, v, rel_k, rel_v, mask)
    assert rel_attention.launches == before + 1
    assert out.shape == (B, H, T, d) and out.transpose(1, 2).is_contiguous()
    ref = rel_attention.relative_self_attention_plain(q.contiguous(), k.contiguous(),
                                                      v.contiguous(), rel_k, rel_v, mask)
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :, :n], ref[b, :, :n], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("T", [37, 128, 1400])
def test_wn_stack_cluster(device, T, B, L, prepared):
    """Both modes (L = 4 one launch, L = 16 one per layer), weights
    prepared ahead or at the call."""
    r = np.random.RandomState(9)
    C, K = 192, 5
    mask = (np.arange(T)[None, :] < np.array([T, T // 2])[:B, None])[..., None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.1,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, r.randn(L, 1, 2 * C) * 0.1)
    before = wn_stack.launches
    if prepared:
        prep = wn_stack.prepare_weights(args[3], args[4])
        out = wn_stack.wn_stack(*args[:3], None, None, args[5], K, prep)
    else:
        out = wn_stack.wn_stack(*args, K)
    assert wn_stack.launches == before + wn_stack.expected_launches(L, K)
    ref = wn_stack.wn_stack_plain(*args, K)
    tol = 5e-5 if L == 4 else 1e-4 * ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C,L", [(64, 4), (256, 4), (256, 16)])
def test_wn_stack_other_widths(device, C, L):
    """One column group per CTA (C = 64), and the widest C = 256, whose
    weight ring is two chunks deep."""
    r = np.random.RandomState(10)
    B, T, K = 1, 300, 5
    mask = (np.arange(T) < T - 40)[None, :, None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.1,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, r.randn(L, 1, 2 * C) * 0.1)
    out = wn_stack.wn_stack(*args, K)
    ref = wn_stack.wn_stack_plain(*args, K)
    tol = 5e-5 if L == 4 else 1e-4 * ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
def test_wn_stack_rejects_channels_the_cluster_does_not_split(device):
    x = torch.zeros(1, 20, 96, device=device)
    before = wn_stack.launches
    with pytest.raises(ValueError, match="steps of 64"):
        wn_stack.wn_stack(x, torch.ones(1, 20, 1, device=device),
                          torch.zeros(1, 4, 192, device=device),
                          torch.zeros(4, 5, 96, 192, device=device),
                          torch.zeros(4, 96, 192, device=device),
                          torch.zeros(4, 1, 192, device=device), 5)
    assert wn_stack.launches == before


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
@pytest.mark.parametrize("T", [37, 1400])
def test_wn_stack_per_layer_mode(device, T):
    """L = 16, k = 5 (the posterior encoder): one launch per layer."""
    r = np.random.RandomState(6)
    B, C, L, K = 2, 192, 16, 5
    mask = (np.arange(T)[None, :] < np.array([T, T // 2])[:, None])[..., None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.1,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, r.randn(L, 1, 2 * C) * 0.1)
    before = wn_stack.launches
    out = wn_stack.wn_stack(*args, K)
    assert wn_stack.launches == before + L
    ref = wn_stack.wn_stack_plain(*args, K)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,fold", [(1200, 32, 4), (4000, 32, 4), (960, 16, 4),
                                      (808, 16, 8)])
def test_mrf_stage_folded(device, dtype, T, C, fold):
    """fold·C = 128 and 64 (zero-padded to 128 in the kernel); T/fold from
    one window to several."""
    r = np.random.RandomState(7)
    x = _cuda(device, r.randn(2, T, C), dtype=dtype)[0]
    packed = [_cuda(device, r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1,
                    r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1) for k in KS]
    before = mrf_stage_folded.launches
    out = mrf_stage_folded.mrf_stack_folded(x, packed, KS, DILS, fold)
    assert mrf_stage_folded.launches == before + 1 and out.dtype == dtype
    ref = mrf_stage_folded.mrf_stack_folded_plain(x, packed, KS, DILS, fold).float()
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * ref.abs().max().item()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(2, 4 * 500), (1, 65536), (2, 131072)])
def test_mrf_stage_folded_shapes(device, B, T, dtype, prepared):
    """The C = 32 stage at fold 4: B = 2 over 500 folded frames (three
    154-frame tiles and a partial last window of 38), the smallest
    bucket's stage (128 frames, 65 536 samples) and B = 2 at 131 072
    samples; weights prepared ahead (as the serving generator keeps them)
    or folded at the call."""
    r = np.random.RandomState(13)
    x = _cuda(device, r.randn(B, T, 32), dtype=dtype)[0]
    packed = [_cuda(device, r.randn(3, k, 32, 32) * 0.05, r.randn(3, 1, 32) * 0.1,
                    r.randn(3, k, 32, 32) * 0.05, r.randn(3, 1, 32) * 0.1) for k in KS]
    prep = mrf_stage_folded.prepare_weights(packed, KS, DILS, 4, 32, dtype) if prepared else None
    before = mrf_stage_folded.launches
    out = mrf_stage_folded.mrf_stack_folded(x, None if prepared else packed, KS, DILS, 4, prep)
    assert mrf_stage_folded.launches == before + 1 and out.dtype == dtype
    ref = mrf_stage_folded.mrf_stack_folded_plain(x, packed, KS, DILS, 4).float()
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * ref.abs().max().item()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)


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


def _mrf_weights(r, C=64, scale=0.03):
    return [[torch.from_numpy(a.astype(np.float32)) for a in (
        r.randn(3, k, C, C) * scale, r.randn(3, 1, C) * 0.1,
        r.randn(3, k, C, C) * scale, r.randn(3, 1, C) * 0.1)] for k in KS]


@pytest.mark.cuda
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(1, 77), (1, 1000), (8, 300), (1, 358400)])
def test_mrf_stage_shapes(device, B, T, dtype, prepared):
    """Below one tile, not a multiple of the tile, a batch of 8, and the
    1400-frame bucket's C = 64 stage; weights prepared ahead (as the serving
    generator keeps them) or at the call."""
    r = np.random.RandomState(11)
    x = _cuda(device, r.randn(B, T, 64), dtype=dtype)[0]
    packed = [[t.to(device) for t in branch] for branch in _mrf_weights(r)]
    prep = mrf_stage.prepare_weights(packed, KS, DILS, dtype) if prepared else None
    before = mrf_stage.launches
    out = mrf_stage.mrf_stack(x, None if prepared else packed, KS, DILS, prep)
    assert mrf_stage.launches == before + 1 and out.dtype == dtype
    ref = mrf_stage.mrf_stack_plain(x, packed, KS, DILS).float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max().item()
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)


@pytest.mark.cuda
def test_generator_keeps_kernel_c_weights_while_frozen(device, monkeypatch):
    """The serving generator prepares kernel C's weights once per frozen
    weight set (and packs none at a request), again after an in-place
    update, and matches the wrapper that prepares them at each call."""
    from vispeech_tpu_torch.models.generator import Generator
    from vispeech_tpu_torch.ops.layers import freeze_weight_norm
    from vispeech_tpu_torch.ops.resblock import ResBlock1

    torch.manual_seed(0)
    gen = Generator(16, "1", KS, DILS, (2,), 128, (4,))   # one stage at C = 64
    for p in gen.parameters():
        p.data.normal_(0.0, 0.05)
    gen = freeze_weight_norm(gen.to(device).eval())
    calls, packs = [], []
    real, real_packed = mrf_stage.prepare_weights, ResBlock1.packed
    monkeypatch.setattr(mrf_stage, "prepare_weights", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(ResBlock1, "packed", lambda self: packs.append(1) or real_packed(self))
    x = torch.randn(2, 50, 16, device=device).bfloat16()
    with torch.no_grad():
        a = gen(x)
        n_packs = len(packs)
        b = gen(x)
        assert len(calls) == 1 and len(packs) == n_packs and torch.equal(a, b)
        gen.resblocks[1].convs2[0].folded.mul_(1.5)
        c = gen(x)
        assert len(calls) == 2 and not torch.equal(a, c)
        gen._kernel_cache.clear()
        for block in gen.resblocks:
            for conv in (*block.convs1, *block.convs2):
                conv.folded = None   # weights recomputed at each call: no cache
        gen.resblocks[1].convs2[0].weight_g.data.mul_(1.5)
        d = gen(x)
    assert len(calls) == 3 and not gen._kernel_cache
    torch.testing.assert_close(d.float(), c.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.zeros(1, 16, 32, device=device)
    with pytest.raises(ValueError, match="C = 64"):
        mrf_stage.mrf_stack(x, [], KS, DILS)
    with pytest.raises(ValueError, match="fold·C <= 128"):
        mrf_stage_folded.mrf_stack_folded(x, [], KS, DILS, 8)
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


def _wn_train_inputs(device, B, T, L, seed=4, C=192, K=5):
    r = np.random.RandomState(seed)
    lengths = np.array([T - 37 * (i % 3) for i in range(B)])
    mask = (np.arange(T)[None, :] < lengths[:, None])[..., None]
    w_rs = r.randn(L, C, 2 * C) * 0.05
    w_rs[-1, :, C:] = 0.0
    b_rs = r.randn(L, 1, 2 * C) * 0.1
    b_rs[-1, :, C:] = 0.0
    args = _cuda(device, r.randn(B, T, C), mask, r.randn(B, L, 2 * C) * 0.3,
                 r.randn(L, K, C, 2 * C) * 0.03, w_rs, b_rs)
    return args, _cuda(device, r.randn(B, T, C))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 4, 16])
@pytest.mark.parametrize("T", [77, 1000, 1024])
def test_wn_stack_train_bf16_backward(device, T, L):
    """The bf16 backward on wgmma against its plain version, with padded
    masks, at T not a multiple of its 128-row tiles and at 1024; two runs
    give the same bits (no atomics in any sum)."""
    K = 5
    args, dout = _wn_train_inputs(device, 3, T, L)
    _, xs = wn_stack_train.wn_stack_train_plain_fwd(*args, K, True)
    grads = wn_stack_train._launch_bwd(dout, xs, *args[1:5], K, True)
    torch.cuda.synchronize()
    _held(grads, wn_stack_train.wn_stack_train_plain_bwd(dout, xs, *args[1:5], K, True), True)
    again = wn_stack_train._launch_bwd(dout, xs, *args[1:5], K, True)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages() if e.self_device_time_total > 0)


@pytest.mark.cuda
def test_wn_stack_train_backward_kernels_by_precision(device):
    """bf16 operands take the wgmma kernels, f32 the 3-pass TF32 mma.sync ones."""
    K = 5
    args, dout = _wn_train_inputs(device, 2, 200, 2, seed=5)
    _, xs = wn_stack_train.wn_stack_train_plain_fwd(*args, K, False)
    names = {bf16: _device_kernels(lambda: wn_stack_train._launch_bwd(dout, xs, *args[1:5], K,
                                                                        bf16))
             for bf16 in (False, True)}
    for kernel in ("bwd_act<false>", "bwd_dx<false>", "wgrad<false>"):
        assert kernel in names[False] and kernel not in names[True]
    for kernel in ("act_kernel", "dx_kernel", "wgrad_kernel"):
        assert kernel in names[True] and kernel not in names[False]


@pytest.mark.cuda
def test_wn_stack_train_bf16_refuses_k7(device):
    args, _ = _wn_train_inputs(device, 1, 40, 1, K=7)
    with pytest.raises(ValueError, match="k <= 5"):
        wn_stack_train.wn_stack_train(*args, 7, bf16_compute=True)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("T", [77, 200, 640])
def test_wn_stack_train_bf16_forward(device, T, L):
    """The bf16 forward on wgmma against its plain version, out and every
    layer's xs, with padded masks, at T not a multiple of its 128-row
    blocks and at a frame bucket; two runs give the same bits."""
    K = 5
    args, _ = _wn_train_inputs(device, 3, T, L)
    out, xs = wn_stack_train._launch_fwd(*args, K, True)
    torch.cuda.synchronize()
    ref, xs_ref = wn_stack_train.wn_stack_train_plain_fwd(*args, K, True)
    _held([out, *xs.unbind(1)], [ref, *xs_ref.unbind(1)], True)
    again = wn_stack_train._launch_fwd(*args, K, True)
    assert torch.equal(out, again[0]) and torch.equal(xs, again[1])


@pytest.mark.cuda
def test_wn_stack_train_bf16_forward_is_one_library_call(device, monkeypatch):
    """A bf16 forward is one call of the library, which launches the wgmma
    layer kernel once a layer; f32 operands take the mma.sync kernel."""
    from vispeech_tpu_torch.ops.kernels import _build

    K, L = 5, 4
    args, _ = _wn_train_inputs(device, 2, 200, L, seed=6)
    wn_stack_train._launch_fwd(*args, K, True)
    key = ("wn_stack_train", "wn_train_bf16_forward")
    calls = []
    fn = _build._FUNCS[key]
    monkeypatch.setitem(_build._FUNCS, key, lambda *a: calls.append(a) or fn(*a))
    names = {bf16: _device_kernels(lambda: wn_stack_train._launch_fwd(*args, K, bf16))
             for bf16 in (True, False)}
    assert len(calls) == 1
    assert names[True].count("wf::layer_kernel") == 2 and "fwd_layer" not in names[True]
    assert "fwd_layer<false>" in names[False] and "wf::" not in names[False]


@pytest.mark.cuda
def test_wn_stack_train_bf16_forward_refuses_on_the_card(device):
    """C ≠ 192 and k > 5 raise on the card: no plain fallback."""
    args, _ = _wn_train_inputs(device, 1, 40, 2, C=128)
    with pytest.raises(ValueError, match="C = 192"):
        wn_stack_train.wn_stack_train(*args, 5, bf16_compute=True)
    args, _ = _wn_train_inputs(device, 1, 40, 2, K=7)
    with pytest.raises(ValueError, match="k <= 5"):
        wn_stack_train.wn_stack_train(*args, 7, bf16_compute=True)
    with pytest.raises(RuntimeError, match="forward kernel launch failed"):
        wn_stack_train._launch_fwd(*args, 7, True)


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_rel,rate,bf16", [(131, 1, 0.1, False), (64, 2, 0.0, False),
                                               (300, 1, 0.1, True), (128, 1, 0.1, True),
                                               (131, 2, 0.1, True), (640, 1, 0.1, True),
                                               (1024, 1, 0.1, True), (1024, 2, 0.0, True)])
def test_rel_attention_train(device, T, n_rel, rate, bf16):
    """Forward and every gradient against the plain version; padded keys
    get zero dk and dv; the bf16 backward (wgmma) gives the same bits twice."""
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
    if bf16:
        out_k, lse_k = rel_attention_train._launch_fwd(*args, 11, rate, 4, True)
        runs = [rel_attention_train._launch_bwd(dout, *args, out_k, lse_k, 11, rate, 4, True)
                for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [77, 200])
def test_rel_attention_train_bf16_operands_in_the_model_layout(device, T):
    """bf16 q, k, v and dO as the attention layer hands them over, [B, T, H,
    d] projections seen as [B, H, T, d]: the bf16 backward reads them through
    their strides and matches the plain version on f32 copies."""
    r = np.random.RandomState(T)
    B, H, d = 3, 2, 96
    mask = (np.arange(T)[None, :] < np.array([T, T - 9, T - 30])[:, None]).astype(np.float32)
    q, k, v, dout = (_cuda(device, r.randn(B, T, H, d), dtype=torch.bfloat16)[0].transpose(1, 2)
                     for _ in range(4))
    rel_k, rel_v, mask_t = _cuda(device, r.randn(1, 9, d) * d ** -0.5,
                                 r.randn(1, 9, d) * d ** -0.5, mask)
    out, lse = rel_attention_train._launch_fwd(q, k, v, rel_k, rel_v, mask_t, 3, 0.1, 4, True)
    grads = rel_attention_train._launch_bwd(dout, q, k, v, rel_k, rel_v, mask_t, out, lse, 3,
                                            0.1, 4, True)
    f = [t.float() for t in (q, k, v, rel_k, rel_v, mask_t)]
    refs = rel_attention_train.relative_self_attention_train_plain_bwd(dout.float(), *f, lse, 3,
                                                                       0.1, 4, True)
    _held(grads, refs, True)


def _attn_inputs(device, B, H, T, d, layout, seed=7):
    """q, k, v on f32 [B, H, T, d] tensors, or (``layout`` "model") bf16 [B,
    T, H, d] projections seen as [B, H, T, d] with bf16 rel tables, as the
    attention layer hands them over; keys padded by 0, 37 and 74 in turn."""
    r = np.random.RandomState(seed)
    lengths = np.array([T - 37 * (i % 3) for i in range(B)])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    rel = [r.randn(1, 9, d) * d ** -0.5 for _ in range(2)]
    if layout == "model":
        qkv = [_cuda(device, r.randn(B, T, H, d), dtype=torch.bfloat16)[0].transpose(1, 2)
               for _ in range(3)]
        return (*qkv, *_cuda(device, *rel, dtype=torch.bfloat16), *_cuda(device, mask))
    return tuple(_cuda(device, *(r.randn(B, H, T, d) for _ in range(3)), *rel, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", "model"])
@pytest.mark.parametrize("T", [77, 128, 640])
def test_rel_attention_train_bf16_forward(device, T, layout):
    """The bf16 forward on wgmma against its plain version on f32 copies of
    the same operands: out and lse to 2^-7 of their peaks, lse also within
    1e-3; two runs give the same bits."""
    args = _attn_inputs(device, 3, 2, T, 96, layout)
    out, lse = rel_attention_train._launch_fwd(*args, 11, 0.1, 4, True)
    torch.cuda.synchronize()
    ref = rel_attention_train.relative_self_attention_train_plain_fwd(
        *(t.float() for t in args), 11, 0.1, 4, True)
    _held((out, lse), ref, True)
    torch.testing.assert_close(lse, ref[1], rtol=0, atol=1e-3)
    again = rel_attention_train._launch_fwd(*args, 11, 0.1, 4, True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
def test_rel_attention_train_bf16_forward_is_one_library_call(device, monkeypatch):
    """A bf16 forward is one call of the library, which launches the wgmma
    kernel once; f32 operands take the CUDA-core kernel."""
    from vispeech_tpu_torch.ops.kernels import _build

    args = _attn_inputs(device, 2, 2, 200, 96, "model")
    rel_attention_train._launch_fwd(*args, 3, 0.1, 4, True)
    key = ("rel_attention_train", "rel_attn_train_fwd_bf16")
    calls = []
    fn = _build._FUNCS[key]
    monkeypatch.setitem(_build._FUNCS, key, lambda *a: calls.append(a) or fn(*a))
    names = {bf16: _device_kernels(lambda: rel_attention_train._launch_fwd(*args, 3, 0.1, 4,
                                                                           bf16))
             for bf16 in (True, False)}
    assert len(calls) == 1
    assert names[True].count("fwd16::attn_kernel") == 1 and "fwd_kernel<" not in names[True]
    assert "fwd_kernel<96>" in names[False] and "fwd16::" not in names[False]


@pytest.mark.cuda
def test_rel_attention_train_bf16_forward_refuses_on_the_card(device):
    """d ∉ {64, 96} raises on the card: no plain fallback."""
    args = _attn_inputs(device, 1, 2, 40, 48, "model")
    with pytest.raises(ValueError, match="d in"):
        rel_attention_train.relative_self_attention_train(*args, 3, 0.1)
    with pytest.raises(RuntimeError, match="bf16 forward kernel launch failed"):
        rel_attention_train._launch_fwd(*args, 3, 0.1, 4, True)


@pytest.mark.cuda
def test_rel_attention_train_backward_kernels_by_precision(device):
    """bf16 operands take the wgmma kernels (prep, then both passes in one
    launch), f32 the CUDA-core bwd_q and bwd_kv kernels."""
    r = np.random.RandomState(6)
    B, H, T, d = 2, 2, 150, 96
    args = _cuda(device, r.randn(B, H, T, d), r.randn(B, H, T, d), r.randn(B, H, T, d),
                 r.randn(1, 9, d) * d ** -0.5, r.randn(1, 9, d) * d ** -0.5, np.ones((B, T)))
    dout = _cuda(device, r.randn(B, H, T, d))[0]
    names = {}
    for bf16 in (False, True):
        out, lse = rel_attention_train._launch_fwd(*args, 3, 0.1, 4, bf16)
        names[bf16] = _device_kernels(lambda: rel_attention_train._launch_bwd(
            dout, *args, out, lse, 3, 0.1, 4, bf16))
    for kernel in ("bwd_q_kernel<96>", "bwd_kv_kernel<96>"):
        assert kernel in names[False] and kernel not in names[True]
    for kernel in ("bwd16::prep_kernel", "bwd16::qkv_kernel"):
        assert kernel in names[True] and kernel not in names[False]


@pytest.mark.cuda
def test_inference_kernels_refuse_autograd_on_the_card(device):
    x = torch.zeros(1, 10, 64, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage.mrf_stack(x, [], KS, DILS)
    with pytest.raises(RuntimeError, match="no backward"):
        mrf_stage_folded.mrf_stack_folded(x[..., :32], [], KS, DILS, 4)
    q = torch.zeros(1, 2, 10, 96, device=device, requires_grad=True)
    rel = torch.zeros(1, 9, 96, device=device)
    with pytest.raises(RuntimeError, match="rel_attention_train"):
        rel_attention.relative_self_attention(q, q, q, rel, rel, torch.ones(1, 10, device=device))
    with torch.no_grad():
        rel_attention.relative_self_attention(q, q, q, rel, rel, torch.ones(1, 10, device=device))


@pytest.mark.cuda
def test_generator_keeps_kernel_d_weights_while_frozen(device, monkeypatch):
    """With frozen weight norms the serving generator prepares kernel D's
    weights once per stage, prepares them again after a re-freeze, and
    matches the wrapper that folds them at each call."""
    from vispeech_tpu_torch.models.generator import Generator
    from vispeech_tpu_torch.ops.layers import freeze_weight_norm

    torch.manual_seed(0)
    gen = Generator(16, "1", KS, DILS, (2,), 64, (4,))
    for p in gen.parameters():
        p.data.normal_(0.0, 0.05)
    gen = freeze_weight_norm(gen.to(device).eval())
    calls = []
    real = mrf_stage_folded.prepare_weights
    monkeypatch.setattr(mrf_stage_folded, "prepare_weights",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 50, 16, device=device)
    with torch.no_grad():
        a, b = gen(x), gen(x)
        assert len(calls) == 1 and torch.equal(a, b)
        freeze_weight_norm(gen)
        gen(x)
        assert len(calls) == 2
        gen._kernel_cache.clear()
        for block in gen.resblocks:
            for conv in (*block.convs1, *block.convs2):
                conv.folded = None   # weights recomputed at each call: no cache
        c = gen(x)
    assert len(calls) == 3 and not gen._kernel_cache
    torch.testing.assert_close(c, a, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_server_on_the_card_launches_the_serving_kernels(device):
    """The port's HTTP server with its coalescer, on an engine at the width
    of ``configs/config.json`` (weights from a seed) on the card: ``GET
    /tts`` answers with 16-bit WAV at the model rate, and kernels A, B, C and
    D launch for it while E and F do not."""
    import os
    import threading
    import urllib.request

    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.infer.server import make_server
    from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
    from vispeech_tpu_torch.ops import kernels
    from vispeech_tpu_torch.text import N_SYMBOLS

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "config.json"))
    model = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed=3)
    with torch.no_grad():
        model.duration_predictor.proj.weight.mul_(0.1)
        model.duration_predictor.proj.bias.fill_(1.8)
    engine = TTSEngine(cfg, model.state_dict())
    httpd, coalescer = make_server(engine, "127.0.0.1", 0, batch_window_ms=20.0, max_batch=16)
    threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
    try:
        kernels.reset_launches()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/tts?text=%5BP%5Dni2%20hao3%5BP%5D"
        with urllib.request.urlopen(url, timeout=300) as r:
            status, body = r.status, r.read()
        counts = kernels.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        coalescer.close()
    assert status == 200 and body[:4] == b"RIFF"
    assert int.from_bytes(body[24:28], "little") == cfg.data.sampling_rate
    n = (len(body) - 44) // 2
    assert n > 0 and n % cfg.data.hop_length == 0
    assert all(counts[k] > 0 for k in ("rel_attention", "wn_stack", "mrf_stage",
                                       "mrf_stage_folded")), counts
    assert all(v == 0 for k, v in counts.items() if "_train_" in k), counts


@pytest.mark.cuda
def test_model_axis_layers_on_the_card(device, tmp_path):
    """The model axis's sharded layers (``tests/torch_tp_jobs.py``'s Conv1d,
    WNConv1d column-parallel and weight-gathered, WNConvTranspose1d with
    its cross-shard norm, ResBlock1) on two ranks sharing ``cuda:0`` over
    gloo, against the whole layer on the card, in f64: output, input
    gradient and every parameter gradient within 1e-10."""
    from test_torch_ddp import Job
    from torch_tp_jobs import job_layers_on_one_card, layer_grads

    Job(tmp_path, 2, job_layers_on_one_card, str(tmp_path)).join()
    want = layer_grads(None, device)
    for r in range(2):
        got = torch.load(tmp_path / f"card{r}.pt", weights_only=False)
        for name, (y, dx, grads, sharded) in got.items():
            want_y, want_dx, want_grads, _ = want[name]
            assert sharded, name
            assert float((y - want_y).abs().max()) <= 1e-10, name
            assert float((dx - want_dx).abs().max()) <= 1e-10, name
            for k, g in grads.items():
                assert float((g - want_grads[k]).abs().max()) <= 1e-10, (name, k)


def _ring_inputs(device, T=700, d=96, lengths=(700, 611)):
    r = np.random.RandomState(3)
    q, k, v = (r.randn(2, 2, T, d) for _ in range(3))
    rel_k, rel_v = (r.randn(9, d) * d ** -0.5 for _ in range(2))
    mask = (np.arange(T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    return _cuda(device, q, k, v, rel_k, rel_v, mask), lengths


@pytest.mark.cuda
def test_ring_attention_one_rank_against_kernel_a(device):
    """The ring at P = 1 (no process group) on CUDA tensors, plain f32
    products with TF32 off, against kernel A on valid rows."""
    from vispeech_tpu_torch.parallel.context import make_ring_attention

    (q, k, v, rel_k, rel_v, mask), lengths = _ring_inputs(device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = make_ring_attention(None)(q, k, v, rel_k, rel_v, mask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    before = rel_attention.launches
    want = rel_attention.relative_self_attention(q, k, v, rel_k[None], rel_v[None], mask)
    assert rel_attention.launches == before + 1
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :, :n], want[b, :, :n], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_shift_on_a_one_rank_nccl_group(device):
    """A 1-rank NCCL world: ``p2p.shift`` returns its input, a CPU tensor
    has no route over NCCL, and the ring's gathers on the world group (through
    NCCL) give the ring of no group."""
    import socket

    import torch.distributed as dist

    from vispeech_tpu_torch.parallel import p2p
    from vispeech_tpu_torch.parallel.context import make_ring_attention

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        world = dist.group.WORLD
        x = torch.ones(4, device=device)
        assert p2p.shift(x, world, 1) is x
        assert not p2p.staged(x.device, world)
        with pytest.raises(RuntimeError, match="no point-to-point route"):
            p2p.staged(torch.device("cpu"), world)
        (q, k, v, rel_k, rel_v, mask), _ = _ring_inputs(device, T=128, lengths=(128, 100))
        with torch.no_grad():
            got = make_ring_attention(world)(q, k, v, rel_k, rel_v, mask)
            want = make_ring_attention(None)(q, k, v, rel_k, rel_v, mask)
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def _seeded_(module, seed):
    """Every parameter and buffer of ``module`` drawn from a seed: norm
    scales 1 + N(0, 0.1²), running variances U(0.5, 1.5), the rest
    U(±1/√fan_in); the affines of the duration flows N(0, 0.1²)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in [*module.named_parameters(), *module.named_buffers()]:
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(p.shape, generator=gen)
            elif name.endswith(("gamma", "norm.weight", "bn.weight")):
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            elif name.endswith((".m", ".logs")):
                v = 0.1 * torch.randn(p.shape, generator=gen)
            else:
                fan_in = p[0].numel() if p.dim() > 1 else p.shape[-1]
                v = (torch.rand(p.shape, generator=gen) * 2 - 1) / fan_in ** 0.5
            p.copy_(v)
    return module


@pytest.mark.cuda
def test_sdp_on_the_card_matches_the_cpu(device):
    """The stochastic duration predictor at full width (hidden 192, a
    256-wide speaker) on the card against the CPU, noise injected: logw
    (sampling) within 1e-4 and the NLL within 1e-4 relative, as phase 4i
    of chip_smoke.py holds them."""
    from vispeech_tpu_torch.models.predictors import StochasticDurationPredictor

    cpu = _seeded_(StochasticDurationPredictor(192, 192, 3, 0.5, 4, gin_channels=256),
                   3).eval()
    card = _seeded_(StochasticDurationPredictor(192, 192, 3, 0.5, 4, gin_channels=256),
                    3).to(device).eval()
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 80, 192, generator=gen)
    mask = (torch.arange(80)[None, :] < torch.tensor([80, 61])[:, None]).float()[..., None]
    g = torch.randn(2, 1, 256, generator=gen)
    noise = torch.randn(2, 80, 2, generator=gen)
    w = torch.randint(1, 9, (2, 80, 1), generator=gen).float() * mask
    on = [t.to(device) for t in (x, mask, g, noise, w)]
    with torch.no_grad():
        want = cpu(x, mask, g=g, reverse=True, noise_scale=0.8, noise=noise)
        got = card(*on[:2], g=on[2], reverse=True, noise_scale=0.8, noise=on[3]).cpu()
        nll_want = cpu(x, mask, w=w, g=g, noise=noise)
        nll_got = card(*on[:2], w=on[4], g=on[2], noise=on[3]).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(nll_got, nll_want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_conformer_on_the_card_matches_the_cpu(device):
    """``ConformerEncoder(192, 2 layers, kernel 31)`` over a padded batch of
    400 frames, eval and one train-mode forward (its BatchNorms' running
    statistics), card against CPU within 1e-4 of each peak."""
    from vispeech_tpu_torch.models.conformer import ConformerEncoder

    cpu = _seeded_(ConformerEncoder(192, n_layers=2, conv_kernel_size=31, p_dropout=0.0), 5)
    card = _seeded_(ConformerEncoder(192, n_layers=2, conv_kernel_size=31, p_dropout=0.0),
                    5).to(device)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 400, 192, generator=gen)
    mask = (torch.arange(400)[None, :] < torch.tensor([400, 310])[:, None]).float()[..., None]
    for train in (False, True):
        cpu.train(train)
        card.train(train)
        with torch.no_grad():
            want = cpu(x, mask)
            got = card(x.to(device), mask.to(device)).cpu()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    for a, b in zip(cpu.buffers(), card.buffers()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
