"""The pieces of kernels A and B's Hopper designs that run in Python.

Kernel A splits the keys across CTAs and merges the partials
(``relative_self_attention_split`` does the same in plain PyTorch, and
``key_splits`` picks the count); kernel B reads its weights split into TF32
hi and lo and laid out in mma fragment order (``prepare_weights``), which
``WN`` keeps while its frozen weights stay the same.  The CUDA kernels
themselves are held against their plain versions in
``tests/test_torch_cuda.py`` on the card.

Tolerances: the split attention and the plain version differ in f32
summation order only (1e-6 absolute on outputs of order 1); against the
Pallas kernel in interpret mode 1e-5, as in ``tests/test_torch_kernels.py``.
The TF32 split leaves w − hi − lo within 2^-20·|w|, so the plain stack on
hi + lo equals it on w to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispeech_tpu.ops.pallas.flash_attention import relative_self_attention as jax_attention
from vispeech_tpu_torch.ops.kernels import rel_attention, wn_stack
from vispeech_tpu_torch.ops.layers import freeze_weight_norm
from vispeech_tpu_torch.ops.wavenet import WN


def _attention_inputs(T, lengths, n_rel=1, d=96, H=2, seed=0):
    r = np.random.RandomState(seed)
    B = len(lengths)
    q, k, v = (r.randn(B, H, T, d).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((r.randn(n_rel, 9, d) * d ** -0.5).astype(np.float32) for _ in range(2))
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, rel_k, rel_v, mask)]


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("T,lengths", [
    (100, (100, 63)),    # T not a multiple of the 32-key tile; bands straddle the splits
    (200, (200, 60)),    # row 1: the last splits' keys all masked
    (96, (96, 0)),       # row 1: every key masked, a uniform softmax
])
def test_split_attention_matches_plain(T, lengths, splits):
    args = _attention_inputs(T, lengths)
    want = rel_attention.relative_self_attention_plain(*args)
    got = rel_attention.relative_self_attention_split(*args, 4, splits)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_split_attention_per_head_tables_d64():
    args = _attention_inputs(129, (129, 90), n_rel=2, d=64)
    want = rel_attention.relative_self_attention_plain(*args)
    got = rel_attention.relative_self_attention_split(*args, 4, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_split_attention_matches_pallas():
    lengths = (150, 97)
    args = _attention_inputs(150, lengths, seed=3)
    ref = np.asarray(jax_attention(*(jnp.asarray(a.numpy()) for a in args), window=4,
                                   interpret=True))
    got = rel_attention.relative_self_attention_split(*args, 4, 3).numpy()
    for b, n in enumerate(lengths):   # valid query rows only
        np.testing.assert_allclose(got[b, :, :n], ref[b, :, :n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,T,splits", [
    (1, 32, 1), (1, 64, 1), (1, 96, 1),   # the phoneme pads: one split
    (1, 129, 2), (1, 512, 8), (1, 1400, 6), (2, 1400, 3), (8, 96, 1),
])
def test_key_splits_at_serving_shapes(B, T, splits):
    H = 2
    assert rel_attention.key_splits(B, H, T) == splits
    tiles = -(-T // 32)
    per_split = -(-tiles // splits)
    # no split is empty, each keeps two tiles, and the grid stays near two CTAs an SM
    assert (splits - 1) * per_split < tiles <= splits * per_split
    assert splits == 1 or per_split >= rel_attention.MIN_SPLIT_TILES
    grid = rel_attention.launch_grid(B, H, T)
    assert grid["ctas"] == B * H * -(-T // 64) * splits <= rel_attention.TARGET_CTAS


@pytest.mark.parametrize("B,T,L,ctas", [
    (1, 128, 4, 12), (1, 1400, 4, 120), (1, 1400, 16, 88), (2, 37, 4, 8), (8, 1400, 4, 960),
])
def test_wn_grid_at_serving_shapes(B, T, L, ctas):
    """64-frame windows: a tile of 48 frames beside the L = 4 couplings'
    8-frame halos, 64 frames per launch in the per-layer mode."""
    assert wn_stack.launch_grid(B, T, L, 5) == {"ctas": ctas, "cluster": 4, "window": 64}
    assert wn_stack.expected_launches(L, 5) == (1 if L == 4 else L)


def test_split_tf32_halves():
    r = np.random.RandomState(1)
    w = torch.from_numpy((r.randn(4096) * np.exp(r.uniform(-20, 5, 4096))).astype(np.float32))
    hi, lo = wn_stack.split_tf32(w)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((w - hi - lo).abs() <= 2.0 ** -20 * w.abs()).all()
    # round to nearest: hi is within half a TF32 ulp of w
    assert ((w - hi).abs() <= 2.0 ** -11 * w.abs()).all()


def test_prepared_weights_layout():
    """CTA r, k-step st, hi or lo, column group s, n8 tile j, k-half kg:
    wgmma's core matrix of columns half·C + r·C/4 + 16·s + 8·(j mod 2) + n
    (n < 8, half = j // 2) × rows 8·st + 4·kg + e (e < 4)."""
    r = np.random.RandomState(2)
    L, k, C = 2, 3, 128
    w_in = torch.from_numpy(r.randn(L, k, C, 2 * C).astype(np.float32))
    w_rs = torch.from_numpy(r.randn(L, C, 2 * C).astype(np.float32))
    prep = wn_stack.prepare_weights(w_in, w_rs)
    assert prep.w_in.shape == (L, 4, k * C // 8, 2, C // 64, 4, 2, 8, 4)
    assert prep.w_rs.shape == (L, 4, C // 8, 2, C // 64, 4, 2, 8, 4)
    n, e = torch.arange(8)[:, None], torch.arange(4)[None, :]
    for w, got in ((w_in.reshape(L, k * C, 2 * C), prep.w_in), (w_rs, prep.w_rs)):
        halves = wn_stack.split_tf32(w)
        for l, cta, st, s, j, kg in ((0, 0, 0, 0, 0, 0), (1, 3, got.shape[2] - 1, 1, 3, 1),
                                     (1, 2, 5, 0, 2, 1), (0, 1, 7, 1, 1, 0)):
            col = (j // 2) * C + cta * (C // 4) + 16 * s + 8 * (j % 2) + n
            for hl, half in enumerate(halves):
                want = half[l, 8 * st + 4 * kg + e, col]
                assert torch.equal(got[l, cta, st, hl, s, j, kg], want)


def test_plain_stack_on_split_weights_matches():
    r = np.random.RandomState(3)
    B, T, C, L, K = 2, 50, 64, 4, 5
    x = torch.from_numpy(r.randn(B, T, C).astype(np.float32))
    mask = torch.from_numpy((np.arange(T)[None, :] < np.array([T, 31])[:, None])
                            .astype(np.float32)[..., None])
    cond = torch.from_numpy((r.randn(B, L, 2 * C) * 0.1).astype(np.float32))
    w_in = torch.from_numpy((r.randn(L, K, C, 2 * C) * 0.05).astype(np.float32))
    w_rs = torch.from_numpy((r.randn(L, C, 2 * C) * 0.1).astype(np.float32))
    b_rs = torch.from_numpy((r.randn(L, 1, 2 * C) * 0.1).astype(np.float32))
    want = wn_stack.wn_stack_plain(x, mask, cond, w_in, w_rs, b_rs, K)
    (hi_in, lo_in), (hi_rs, lo_rs) = wn_stack.split_tf32(w_in), wn_stack.split_tf32(w_rs)
    got = wn_stack.wn_stack_plain(x, mask, cond, hi_in + lo_in, hi_rs + lo_rs, b_rs, K)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_wrapper_rejects_channels_the_cluster_does_not_split():
    with pytest.raises(ValueError, match="steps of 64"):
        wn_stack.prepare_weights(torch.zeros(2, 5, 96, 192), torch.zeros(2, 96, 192))
    with pytest.raises(ValueError, match="odd k"):
        wn_stack.prepare_weights(torch.zeros(2, 4, 64, 128), torch.zeros(2, 64, 128))
    with pytest.raises(ValueError, match="C <= 256"):
        wn_stack.prepare_weights(torch.zeros(2, 5, 320, 640), torch.zeros(2, 320, 640))


def _wn(seed=4, C=64, L=4, G=8):
    torch.manual_seed(seed)
    wn = WN(C, 5, 1, L, gin_channels=G)
    for p in wn.parameters():
        p.data.normal_(0.0, 0.1)
    return wn


def test_wn_keeps_prepared_operands_while_frozen(monkeypatch):
    calls = []
    real = wn_stack.prepare_weights
    monkeypatch.setattr(wn_stack, "prepare_weights", lambda *a: calls.append(1) or real(*a))
    wn = freeze_weight_norm(_wn().eval())
    first = wn.kernel_operands()
    assert wn.kernel_operands() is first and len(calls) == 1
    cond, w_in, w_rs, b_rs = wn.packed(1, None)
    assert torch.equal(first[0], cond[0]) and torch.equal(first[2], b_rs)
    assert torch.equal(first[1].w_in, real(w_in, w_rs).w_in)
    # an in-place edit of a frozen weight bumps its version: prepared again
    with torch.no_grad():
        wn.in_layers[2].folded.mul_(2.0)
    again = wn.kernel_operands()
    assert len(calls) == 2 and not torch.equal(again[1].w_in, first[1].w_in)
    assert wn.kernel_operands() is again and len(calls) == 2
    # a re-freeze makes new tensors: prepared again
    freeze_weight_norm(wn)
    wn.kernel_operands()
    assert len(calls) == 3


def test_wn_caches_nothing_unfrozen_or_on_the_cpu(monkeypatch):
    calls = []
    real = wn_stack.prepare_weights
    monkeypatch.setattr(wn_stack, "prepare_weights", lambda *a: calls.append(1) or real(*a))
    wn = _wn().eval()
    wn.kernel_operands()
    wn.kernel_operands()
    assert len(calls) == 2 and wn._kernel_cache is None
    frozen = freeze_weight_norm(_wn().eval())
    x = torch.randn(2, 30, 64)
    with torch.no_grad():
        frozen(x, torch.ones(2, 30, 1), torch.randn(2, 1, 8))
    assert frozen._kernel_cache is None and len(calls) == 2
