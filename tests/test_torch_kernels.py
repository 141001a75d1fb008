"""The port's three serving kernels held against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; here that
version is held against the Pallas kernel in interpret mode and against
the JAX package's unfused (XLA) formulation, on the same numpy inputs.
``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.

Tolerances: both sides compute in f32 and differ only in summation order;
1e-5 absolute (2e-5 for the 4-layer WN stack and the 18-conv MRF stage,
whose outputs reach |x| ≈ 5) covers that with margin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.ops.attention import (
    _absolute_to_relative,
    _pad_rel_embeddings,
    _relative_to_absolute,
)
from vispeech_tpu.ops.pallas.flash_attention import relative_self_attention as jax_attention
from vispeech_tpu.ops.pallas.mrf_stage import mrf_stack as jax_mrf_stack
from vispeech_tpu.ops.pallas.wn_stack import wn_stack as jax_wn_stack
from vispeech_tpu.ops.resblock import ResBlock1 as JaxResBlock1
from vispeech_tpu_torch.ops.kernels import mrf_stage, rel_attention, wn_stack

ATOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _attention_inputs(T, lengths, n_rel=1, d=96, B=2, H=2, seed=0):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, H, T, d).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((r.randn(n_rel, 9, d) * d ** -0.5).astype(np.float32)
                    for _ in range(2))
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, rel_k, rel_v, mask


def _xla_attention(q, k, v, rel_k, rel_v, mask, window=4):
    """The unfused ops/attention.py formulation, outer-product mask."""
    B, H, T, d = q.shape
    qs = jnp.asarray(q) / math.sqrt(d)
    hi = jax.lax.Precision.HIGHEST
    scores = jnp.einsum("bhtd,bhsd->bhts", qs, k, precision=hi)
    rk = jax.vmap(lambda r: _pad_rel_embeddings(r, T, window))(jnp.asarray(rel_k))
    scores = scores + _relative_to_absolute(
        jnp.einsum("bhtd,hmd->bhtm", qs, rk, precision=hi))
    outer = mask[:, None, :, None] * mask[:, None, None, :]
    p = jax.nn.softmax(jnp.where(outer == 0, -1e4, scores), axis=-1)
    rv = jax.vmap(lambda r: _pad_rel_embeddings(r, T, window))(jnp.asarray(rel_v))
    out = jnp.einsum("bhts,bhsd->bhtd", p, v, precision=hi)
    return np.asarray(out + jnp.einsum("bhtm,hmd->bhtd", _absolute_to_relative(p), rv,
                                       precision=hi))


class TestRelAttention:
    @pytest.mark.parametrize("T,lengths", [(100, (100, 63)), (200, (200, 150)),
                                           (256, (256, 1))])
    def test_matches_pallas_and_xla(self, T, lengths):
        inputs = _attention_inputs(T, lengths)
        ref = np.asarray(jax_attention(*map(jnp.asarray, inputs), window=4,
                                       interpret=True))
        xla = _xla_attention(*inputs)
        out = rel_attention.relative_self_attention(*_t(*inputs)).numpy()
        for b, n in enumerate(lengths):  # valid query rows only
            np.testing.assert_allclose(out[b, :, :n], ref[b, :, :n], rtol=0, atol=ATOL)
            np.testing.assert_allclose(out[b, :, :n], xla[b, :, :n], rtol=0, atol=ATOL)

    def test_per_head_tables(self):
        inputs = _attention_inputs(128, (128, 90), n_rel=2, d=64)
        ref = np.asarray(jax_attention(*map(jnp.asarray, inputs), window=4,
                                       interpret=True))
        out = rel_attention.relative_self_attention(*_t(*inputs)).numpy()
        np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=ATOL)
        np.testing.assert_allclose(out[1, :, :90], ref[1, :, :90], rtol=0, atol=ATOL)

    def test_fully_masked_row_finite(self):
        q, k, v, rel_k, rel_v, mask = _attention_inputs(40, (5, 0))
        out = rel_attention.relative_self_attention(*_t(q, k, v, rel_k, rel_v, mask))
        assert torch.isfinite(out).all()
        # with no valid key the softmax is uniform over all keys
        uniform = v[1].mean(axis=1)
        assert np.abs(out[1, :, 20].numpy() - uniform - rel_v[0].sum(0) / 40).max() < 1e-5

    def test_cpu_tensor_takes_plain_version(self):
        before = rel_attention.launches
        rel_attention.relative_self_attention(*_t(*_attention_inputs(16, (16, 8))))
        assert rel_attention.launches == before


def _wn_inputs(with_g, B=2, T=100, C=32, L=4, k=5, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, T, C).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 63])[:, None]).astype(np.float32)[..., None]
    cond = (r.randn(B, L, 2 * C) * 0.1).astype(np.float32)
    if not with_g:
        cond = np.broadcast_to(cond[:1], cond.shape).copy()
    w_in = (r.randn(L, k, C, 2 * C) * 0.05).astype(np.float32)
    w_rs = (r.randn(L, C, 2 * C) * 0.1).astype(np.float32)
    w_rs[-1, :, C:] = 0.0
    b_rs = (r.randn(L, 1, 2 * C) * 0.1).astype(np.float32)
    b_rs[-1, :, C:] = 0.0
    return x, mask, cond, w_in, w_rs, b_rs


class TestWNStack:
    @pytest.mark.parametrize("with_g", [True, False])
    def test_matches_pallas(self, with_g):
        inputs = _wn_inputs(with_g)
        ref = np.asarray(jax_wn_stack(*map(jnp.asarray, inputs), 5, interpret=True))
        out = wn_stack.wn_stack(*_t(*inputs), 5).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)

    def test_module_kernel_path_matches_jax_wn(self):
        """The WN module packed for kernel B ≡ the JAX WN (XLA loop), g live."""
        from vispeech_tpu.ops.wavenet import WN as JaxWN
        from vispeech_tpu_torch.ops.wavenet import WN
        from vispeech_tpu_torch.utils.jax_weights import load_flax_params

        B, T, C, G = 2, 60, 16, 8
        r = np.random.RandomState(1)
        x = r.randn(B, T, C).astype(np.float32)
        g = r.randn(B, 1, G).astype(np.float32)
        mask = (np.arange(T)[None, :] < np.array([60, 41])[:, None]).astype(np.float32)[..., None]
        jwn = JaxWN(C, 5, 1, 4, gin_channels=G, use_pallas=False)
        shapes = jax.eval_shape(jwn.init, jax.random.PRNGKey(0), x, mask, g=g)["params"]
        flat = {k: (r.randn(*v.shape) * 0.2).astype(np.float32)
                for k, v in flatten_dict(shapes, sep="/").items()}
        params = {"params": unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
        ref = np.asarray(jwn.apply(params, x, mask, g=g))
        wn = WN(C, 5, 1, 4, gin_channels=G)
        load_flax_params(wn, flat)
        out = wn(*_t(x, mask), g=torch.from_numpy(g)).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _mrf_inputs(T, C=16, seed=1):
    r = np.random.RandomState(seed)
    x = r.randn(1, T, C).astype(np.float32)
    packed = tuple(
        tuple(a.astype(np.float32) for a in (
            r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1,
            r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1))
        for k in KS)
    return x, packed


class TestMRFStage:
    @pytest.mark.parametrize("T", [300, 130])
    def test_matches_pallas_across_tiles(self, T):
        x, packed = _mrf_inputs(T)
        ref = np.asarray(jax_mrf_stack(jnp.asarray(x), jax.tree.map(jnp.asarray, packed),
                                       KS, DILS, tile=128, interpret=True))
        out = mrf_stage.mrf_stack(torch.from_numpy(x), [_t(*p) for p in packed],
                                  KS, DILS).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)

    def test_matches_xla_resblock_average(self):
        """The JAX ResBlock1 modules (XLA convs) averaged ≡ the plain stage."""
        C, T = 16, 90
        r = np.random.RandomState(2)
        x = r.randn(2, T, C).astype(np.float32)
        refs, packed = [], []
        for i, k in enumerate(KS):
            block = JaxResBlock1(C, k, (1, 3, 5))
            shapes = jax.eval_shape(block.init, jax.random.PRNGKey(i), x)["params"]
            tree = jax.tree.map(
                lambda s: jnp.asarray((r.randn(*s.shape) * 0.1 + (s.ndim == 1)).astype(
                    np.float32)), shapes)
            refs.append(np.asarray(block.apply({"params": tree}, x)))
            packed.append(_t(*(np.asarray(a) for a in block.apply(
                {"params": tree}, x, collect=True))))
        out = mrf_stage.mrf_stack(torch.from_numpy(x), packed, KS, DILS).numpy()
        np.testing.assert_allclose(out, sum(refs) / 3, rtol=0, atol=2e-5)

    def test_bf16_plain_rounds_operands(self):
        """In bf16 the plain version rounds each conv operand and the output
        to bf16 and keeps f32 state: within bf16 resolution of the f32 run."""
        x, packed = _mrf_inputs(200)
        xt = torch.from_numpy(x)
        w = [_t(*p) for p in packed]
        f32 = mrf_stage.mrf_stack(xt, w, KS, DILS)
        bf16 = mrf_stage.mrf_stack(xt.bfloat16(), w, KS, DILS)
        assert bf16.dtype == torch.bfloat16
        err = (bf16.float() - f32).abs().max() / f32.abs().max()
        assert 0 < err < 2e-2
