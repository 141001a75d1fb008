"""The port's polyphase-folded MRF stage and kernel D held against the JAX
package.

``ops/folded_mrf.py`` against ``vispeech_tpu/ops/folded_mrf.py`` (weights
and stage); kernel D's plain version, which its wrapper runs on a CPU
tensor, against the Pallas kernel ``mrf_stack_folded`` in interpret mode;
and the fused generator, whose narrow stages go through kernel D's wrapper,
against the JAX generator's fused path.  ``tests/test_torch_cuda.py`` holds
the CUDA kernel against its plain version on the card.

Tolerances: in f32 both sides differ only in summation order: the folded
weights are exact copies (0/1 scatter), stages 2e-5 absolute on outputs of
order 1–5 (as the other MRF tests).  With bf16 inputs both sides round
every conv operand and the output to bf16 at the same places; a sum taken
in another order can move a rounding by one bf16 ulp, so the output is
held to 2^-7 of its peak, one bf16 ulp in the peak's binade.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.models.generator import Generator as JaxGenerator
from vispeech_tpu.ops.folded_mrf import fold_conv_weights as jax_fold_conv_weights
from vispeech_tpu.ops.folded_mrf import mrf_stage_folded as jax_mrf_stage_folded
from vispeech_tpu.ops.pallas.mrf_stage import mrf_stack_folded as jax_mrf_stack_folded
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.ops import folded_mrf
from vispeech_tpu_torch.ops.kernels import _build, mrf_stage_folded
from vispeech_tpu_torch.utils.jax_weights import load_flax_params

ATOL = 2e-5
KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _stage_inputs(B, T, C, kernels, dils, seed=0, scale=0.05):
    r = np.random.RandomState(seed)
    x = r.randn(B, T, C).astype(np.float32)
    packed = tuple(
        tuple(a.astype(np.float32) for a in (
            r.randn(len(d), k, C, C) * scale, r.randn(len(d), 1, C) * 0.1,
            r.randn(len(d), k, C, C) * scale, r.randn(len(d), 1, C) * 0.1))
        for k, d in zip(kernels, dils))
    return x, packed


# the cases of tests/test_pallas_kernels.py::TestFoldedMRF
STAGES = {
    "fold4_C32": dict(C=32, T=128, fold=4, kernels=KS, dils=DILS),
    "fold8_C16": dict(C=16, T=104, fold=8, kernels=KS, dils=DILS),
    "fold2_single_branch": dict(C=8, T=30, fold=2, kernels=(5,), dils=((1, 2),)),
}


class TestFoldedMRF:
    @pytest.mark.parametrize("case", sorted(STAGES))
    def test_fold_conv_weights(self, case):
        s = STAGES[case]
        _, packed = _stage_inputs(2, s["T"], s["C"], s["kernels"], s["dils"])
        for (w1, b1, w2, b2), dils in zip(packed, s["dils"]):
            for u, d in enumerate(dils):
                for w, b, dil in ((w1, b1, d), (w2, b2, 1)):
                    wf, bf, pads = folded_mrf.fold_conv_weights(
                        *_t(w[u], b[u, 0]), dil, s["fold"])
                    jwf, jbf, jpads = jax_fold_conv_weights(
                        jnp.asarray(w[u]), jnp.asarray(b[u, 0]), dil, s["fold"])
                    assert pads == tuple(jpads)
                    np.testing.assert_array_equal(wf.numpy(), np.asarray(jwf))
                    np.testing.assert_array_equal(bf.numpy(), np.asarray(jbf))

    @pytest.mark.parametrize("case", sorted(STAGES))
    def test_stage_matches_jax(self, case):
        s = STAGES[case]
        x, packed = _stage_inputs(2, s["T"], s["C"], s["kernels"], s["dils"])
        ref = np.asarray(jax_mrf_stage_folded(
            jnp.asarray(x), jax.tree.map(jnp.asarray, packed), s["kernels"], s["dils"],
            s["fold"]))
        out = folded_mrf.mrf_stage_folded(torch.from_numpy(x), [_t(*p) for p in packed],
                                          s["kernels"], s["dils"], s["fold"]).numpy()
        assert np.abs(ref).max() > 0.5
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)

    def test_identity_conv_folds_to_identity(self):
        """A k = 1 identity conv folds to a block-diagonal identity."""
        wf, bf, pads = folded_mrf.fold_conv_weights(torch.eye(4)[None], torch.zeros(4), 1, 4)
        assert wf.shape == (1, 16, 16) and pads == (0, 0)
        np.testing.assert_array_equal(wf[0].numpy(), np.eye(16))
        np.testing.assert_array_equal(bf.numpy(), np.zeros(16))

    def test_indivisible_t_raises(self):
        x, packed = _stage_inputs(2, 31, 8, (3,), ((1,),))
        with pytest.raises(ValueError, match="not divisible"):
            jax_mrf_stage_folded(jnp.asarray(x), jax.tree.map(jnp.asarray, packed), (3,),
                                 ((1,),), 2)
        with pytest.raises(ValueError, match="not divisible"):
            folded_mrf.mrf_stage_folded(torch.from_numpy(x), [_t(*p) for p in packed], (3,),
                                        ((1,),), 2)
        with pytest.raises(ValueError, match="not divisible"):
            mrf_stage_folded.mrf_stack_folded(torch.from_numpy(x), [_t(*p) for p in packed],
                                              (3,), ((1,),), 2)


def _unpacked_taps(prep):
    """Every tap of prepared weights as [taps, cin, cout] f32, taken back out
    of the kernel's layout (bf16: [cout/8][cin/8][8 cout][8 cin])."""
    taps = prep.w.reshape(-1, 128, 128).float()
    if prep.dtype == torch.bfloat16:
        taps = taps.reshape(-1, 16, 16, 8, 8).permute(0, 2, 4, 1, 3).reshape(-1, 128, 128)
    return taps


def _assert_taps(prep, w, fold, cf):
    """Each folded conv's taps, zero-padded past ``cf``, and its pads, in
    the order the kernel takes them."""
    taps, off, n = _unpacked_taps(prep), 0, 0
    for units in folded_mrf.folded_units(w, DILS, fold):
        for wf, bf, pads in (conv for unit in units for conv in unit):
            kf = wf.shape[0]
            want = torch.zeros(kf, 128, 128)
            want[:, :cf, :cf] = wf
            assert prep.pads[2 * n:2 * n + 2] == pads
            torch.testing.assert_close(taps[off:off + kf], want.to(prep.dtype).float(),
                                       rtol=0, atol=0)
            torch.testing.assert_close(prep.b[128 * n:128 * (n + 1)],
                                       torch.nn.functional.pad(bf, (0, 128 - cf)), rtol=0,
                                       atol=0)
            off, n = off + kf, n + 1
    assert off * 128 * 128 == prep.w.numel() and 128 * n == prep.b.numel()


class TestKernelDPlain:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_across_tiles(self, dtype):
        """B = 2, T = 1024, C = 16, fold 4: 256 folded frames in two 128-frame
        Pallas tiles, so the neighbour-tile halo is exercised."""
        x, packed = _stage_inputs(2, 1024, 16, KS, DILS)
        jx = jnp.asarray(x).astype(dtype)
        ref = jax_mrf_stack_folded(jx, jax.tree.map(jnp.asarray, packed), KS, DILS, fold=4,
                                   tile=128, interpret=True)
        ref = np.asarray(ref.astype(jnp.float32))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        before = mrf_stage_folded.launches
        out = mrf_stage_folded.mrf_stack_folded(xt, [_t(*p) for p in packed], KS, DILS, 4)
        assert mrf_stage_folded.launches == before   # a CPU tensor takes the plain version
        assert out.dtype == xt.dtype and out.shape == x.shape
        peak = np.abs(ref).max()
        tol = ATOL if dtype == "float32" else 2.0 ** -7 * peak
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_prepared_weights_layout(self, dtype):
        """The kernel's operands for the configured C = 32 stage at fold 4:
        92 taps of 128 × 128, [cout/8][cin/8][8 cout][8 cin] core matrices
        in bf16 and (cin, cout) in f32, a folded receptive radius of 19
        frames.  The layout is inverted here and every tap compared."""
        _, packed = _stage_inputs(1, 8, 32, KS, DILS)
        w = [_t(*p) for p in packed]
        prep = mrf_stage_folded.prepare_weights(w, KS, DILS, 4, 32, dtype)
        assert prep.w.dtype == dtype and prep.w.numel() == 92 * 128 * 128
        assert prep.halo == 19 and prep.cf == 128 and (prep.n_br, prep.n_unit) == (3, 3)
        _assert_taps(prep, w, 4, 128)
        wf, bf, pads = folded_mrf.fold_conv_weights(w[2][0][2], w[2][1][2, 0], 5, 4)
        assert prep.pads[-4:-2] == pads == (7, 7) and wf.shape[0] == 15
        torch.testing.assert_close(prep.b[-256:-128], bf, rtol=0, atol=0)
        with pytest.raises(ValueError, match="fold·C <= 128"):
            mrf_stage_folded.prepare_weights(w, KS, DILS, 8, 32, dtype)
        with pytest.raises(ValueError, match="branches"):
            mrf_stage_folded.prepare_weights(w[:2], KS, DILS, 4, 32, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_prepared_weights_pad_narrow_stages(self, dtype):
        """fold·C = 64 (C = 16 at fold 4): every tap and bias zero-padded to
        128 channels, so the padded channels stay 0 in the kernel."""
        _, packed = _stage_inputs(1, 8, 16, KS, DILS, seed=3)
        w = [_t(*p) for p in packed]
        prep = mrf_stage_folded.prepare_weights(w, KS, DILS, 4, 16, dtype)
        assert prep.cf == 64 and prep.halo == 19
        _assert_taps(prep, w, 4, 64)

    def test_bf16_kernel_refuses_pads_beyond_its_slack(self):
        """At fold 2 the k = 11, d = 5 conv spans 13 folded frames on each
        side, more than the bf16 kernel's 8 slack rows; the f32 kernel has
        no such limit."""
        _, packed = _stage_inputs(1, 8, 8, (11,), ((1, 3, 5),))
        w = [_t(*p) for p in packed]
        f32 = mrf_stage_folded.prepare_weights(w, (11,), ((1, 3, 5),), 2, 8, torch.float32)
        assert max(f32.pads) == 13
        with pytest.raises(ValueError, match="slack rows"):
            mrf_stage_folded.prepare_weights(w, (11,), ((1, 3, 5),), 2, 8, torch.bfloat16)

    def test_stage_without_weights_is_refused(self):
        x = torch.zeros(1, 32, 32)
        with pytest.raises(ValueError, match="packed weights or prepared ones"):
            mrf_stage_folded.mrf_stack_folded(x, None, KS, DILS, 4)
        # the plain version on the CPU reads packed weights, not the kernel's layout
        _, packed = _stage_inputs(1, 8, 32, KS, DILS)
        prep = mrf_stage_folded.prepare_weights([_t(*p) for p in packed], KS, DILS, 4, 32,
                                                torch.float32)
        with pytest.raises(ValueError, match="packed weights on a CPU tensor"):
            mrf_stage_folded.mrf_stack_folded(x, None, KS, DILS, 4, prep)

    def test_launch_grid_is_the_kernels_grid(self):
        """``launch_grid`` restates the grid ``csrc/mrf_stage_folded.cu``
        launches, by which the wrapper sizes the scratch of branch sums its
        bf16 blocks take: one block per tile of each batch item."""
        src = (_build.CSRC / "mrf_stage_folded.cu").read_text()
        D = mrf_stage_folded
        for name, value in (("WIN", D.WIN), ("PADR", D.MAX_PAD), ("CF", D.MAX_CF),
                            ("NACC", D.SCRATCH // 384)):
            assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
        assert "constexpr int NWG = WIN / 64;" in src and "constexpr int NCT = NCW * 32;" in src
        assert "dim3 grid((Tf + tile - 1) / tile, B);" in src
        for B in (1, 2, 8):
            for tf in (1, 153, 154, 155, 309, 16384, 179200):
                grid = D.launch_grid(B, tf, 19)
                per_item, tile = grid["blocks"] // B, grid["tile"]
                assert tile == 154 and grid["blocks"] == B * per_item
                assert (per_item - 1) * tile < tf <= per_item * tile

    def test_plain_equals_folded_stage_in_f32(self):
        """In f32 the kernel's arithmetic (f32 state) is the XLA folded stage's."""
        x, packed = _stage_inputs(1, 256, 32, KS, DILS, seed=2)
        w = [_t(*p) for p in packed]
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(
            mrf_stage_folded.mrf_stack_folded_plain(xt, w, KS, DILS, 4).numpy(),
            folded_mrf.mrf_stage_folded(xt, w, KS, DILS, 4).numpy(), rtol=0, atol=ATOL)


class TestFusedGenerator:
    def test_matches_jax_fused(self, monkeypatch):
        """Rates (2, 2) from 64 channels: stages at C = 32 (fold 4) and C = 16
        (fold 8), both through kernel D's wrapper in the port and the XLA
        folded path in JAX (``fused=True``); weight-norm decoder weights at
        N(0, 0.05²); f32."""
        r = np.random.RandomState(4)
        x = r.randn(2, 12, 16).astype(np.float32)
        g = r.randn(2, 1, 8).astype(np.float32)
        jm = JaxGenerator("1", KS, DILS, (2, 2), 64, (4, 4), gin_channels=8)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, g)["params"]
        flat = {}
        for name, s in flatten_dict(shapes, sep="/").items():
            a = r.randn(*s.shape)
            flat[name] = (np.abs(a) + 0.5 if name.endswith("/g") else a * 0.05).astype(
                np.float32)
        variables = {"params": unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
        ref = np.asarray(jm.apply(variables, x, g, fused=True))
        ours = load_flax_params(Generator(16, "1", KS, DILS, (2, 2), 64, (4, 4),
                                          gin_channels=8), flat).eval()
        calls = []
        real = mrf_stage_folded.mrf_stack_folded

        def spy(x, packed, kernel_sizes, dilations, fold, prepared=None):
            calls.append((x.shape[-1], fold))
            return real(x, packed, kernel_sizes, dilations, fold, prepared)

        monkeypatch.setattr(mrf_stage_folded, "mrf_stack_folded", spy)
        with torch.no_grad():
            out = ours(*_t(x, g)).numpy()
        assert calls == [(32, 4), (16, 8)]
        assert out.shape == ref.shape == (2, 48, 1)
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
