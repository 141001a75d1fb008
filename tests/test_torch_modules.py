"""Port modules against their JAX counterparts, at small widths.

Every flax leaf is drawn at random from numpy (shapes from ``eval_shape``,
nothing from a flax initialiser) and carried onto the port by
``utils/jax_weights.py``; both sides run in f32 on the CPU with the same
inputs.  Tolerance 1e-5 absolute unless stated: summation order only, on
outputs of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.models.generator import Generator as JaxGenerator
from vispeech_tpu.models.predictors import (
    DurationPredictor as JaxDurationPredictor,
    EnergyPredictor as JaxEnergyPredictor,
    PitchPredictor as JaxPitchPredictor,
)
from vispeech_tpu.ops import layers as jax_layers
from vispeech_tpu.ops.attention import Encoder as JaxEncoder
from vispeech_tpu.ops.flows import ResidualCouplingLayer as JaxCoupling
from vispeech_tpu.ops.length_regulator import length_regulate as jax_length_regulate
from vispeech_tpu.ops.masking import generate_path as jax_generate_path
from vispeech_tpu.text import cleaner as jax_cleaner
from vispeech_tpu.text.symbols import symbols as JAX_SYMBOLS
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.models.predictors import (
    DurationPredictor,
    EnergyPredictor,
    PitchPredictor,
)
from vispeech_tpu_torch.ops import layers
from vispeech_tpu_torch.ops.attention import Encoder
from vispeech_tpu_torch.ops.flows import ResidualCouplingLayer
from vispeech_tpu_torch.ops.length_regulator import length_regulate
from vispeech_tpu_torch.ops.masking import generate_path, length_mask
from vispeech_tpu_torch.text import N_SYMBOLS, cleaned_text_to_sequence, symbols, text_to_phones
from vispeech_tpu_torch.utils.jax_weights import load_flax_params

ATOL = 1e-5


def random_params(module, *args, seed=0, scale=0.2, **kw):
    """(flax variables, flat numpy tree) with every leaf drawn from numpy:
    N(0, scale²) for weights, |N| + 0.5 for weight-norm gains, 1 + N(0, 0.1²)
    for norm scales."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)["params"]
    r = np.random.RandomState(seed)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        else:
            a = a * scale
        flat[name] = a.astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return {"params": tree}, flat


def port(module, flat):
    return load_flax_params(module, flat).eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def masked_input(B=2, T=24, C=16, lengths=(24, 17), seed=1):
    r = np.random.RandomState(seed)
    x = r.randn(B, T, C).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    return x, mask


class TestLayers:
    @pytest.mark.parametrize("k,dilation", [(1, 1), (3, 1), (5, 3)])
    def test_conv1d(self, k, dilation):
        x, _ = masked_input()
        jm = jax_layers.Conv1d(12, k, dilation=dilation)
        variables, flat = random_params(jm, x)
        ours = port(layers.Conv1d(16, 12, k, dilation=dilation), flat)
        np.testing.assert_allclose(ours(t(x)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x)), atol=ATOL)

    def test_wn_conv1d(self):
        x, _ = masked_input()
        jm = jax_layers.WNConv1d(20, 7, dilation=3)
        variables, flat = random_params(jm, x)
        ours = port(layers.WNConv1d(16, 20, 7, dilation=3), flat)
        np.testing.assert_allclose(ours(t(x)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x)), atol=ATOL)

    @pytest.mark.parametrize("k,u", [(16, 8), (4, 2), (4, 4)])
    def test_wn_conv_transpose(self, k, u):
        """Flipped [k, cin, cout] flax kernel ↔ torch [cin, cout, k], weight
        norm per input channel, output length T·u."""
        x, _ = masked_input(T=10)
        jm = jax_layers.WNConvTranspose1d(8, k, u)
        variables, flat = random_params(jm, x)
        # the flip is told apart by its place in the generator (``up_i``)
        ours = torch.nn.Module()
        ours.ups = torch.nn.ModuleList([layers.WNConvTranspose1d(16, 8, k, u)])
        port(ours, {f"up_0/{name}": a for name, a in flat.items()})
        out = ours.ups[0](t(x)).detach().numpy()
        assert out.shape == (2, 10 * u, 8)
        np.testing.assert_allclose(out, np.asarray(jm.apply(variables, x)), atol=ATOL)

    def test_layer_norm(self):
        x, _ = masked_input()
        x = x * 3.0 + 1.0
        jm = jax_layers.LayerNorm()
        variables, flat = random_params(jm, x)
        ours = port(layers.LayerNorm(16), flat)
        np.testing.assert_allclose(ours(t(x)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x)), atol=ATOL)


class TestMaskingAndLengthRegulator:
    def test_generate_path_and_regulate(self):
        r = np.random.RandomState(0)
        dur = r.randint(-2, 5, (2, 7)).astype(np.int32)
        np.testing.assert_array_equal(
            generate_path(t(np.maximum(dur, 0)), 30).numpy(),
            np.asarray(jax_generate_path(jnp.asarray(np.maximum(dur, 0)), 30)))
        x = r.randn(2, 7, 5).astype(np.float32)
        frames, lengths = length_regulate(t(x), t(dur.astype(np.float32)), 30)
        jf, jl = jax_length_regulate(jnp.asarray(x), jnp.asarray(dur), 30)
        np.testing.assert_allclose(frames.numpy(), np.asarray(jf), atol=ATOL)
        # negative durations clamp to 0; the frame length is their sum
        np.testing.assert_array_equal(lengths.numpy(), np.maximum(dur, 0).sum(1))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))

    def test_length_mask(self):
        m = length_mask(torch.tensor([3, 0, 5]), 5)
        assert m.shape == (3, 5, 1)
        np.testing.assert_array_equal(m[..., 0].sum(1).numpy(), [3, 0, 5])


class TestEncoderAndHeads:
    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_encoder(self, use_pallas):
        """Against the JAX encoder on its XLA path and on the Pallas kernel
        (interpret mode on the CPU)."""
        x, mask = masked_input(T=40, C=32, lengths=(40, 23))
        jm = JaxEncoder(32, 48, n_heads=2, n_layers=2, kernel_size=3, use_pallas=use_pallas)
        variables, flat = random_params(jm, x, mask)
        ours = port(Encoder(32, 48, 2, 2, 3), flat)
        np.testing.assert_allclose(ours(t(x), t(mask)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x, mask)), atol=ATOL)

    def test_duration_predictor(self):
        x, mask = masked_input(C=16)
        g = np.random.RandomState(3).randn(2, 1, 8).astype(np.float32)
        jm = JaxDurationPredictor(24, 3, 0.5, gin_channels=8)
        variables, flat = random_params(jm, x, mask, g=g)
        ours = port(DurationPredictor(16, 24, 3, gin_channels=8), flat)
        np.testing.assert_allclose(ours(t(x), t(mask), t(g)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x, mask, g=g)), atol=ATOL)

    def test_pitch_predictor(self):
        x, mask = masked_input(C=16)
        g = np.random.RandomState(3).randn(2, 1, 8).astype(np.float32)
        jm = JaxPitchPredictor(16, 32, 2, 3, 0.1, gin_channels=8, use_pallas=False)
        variables, flat = random_params(jm, x, mask, g=g)
        ours = port(PitchPredictor(16, 32, 2, 3, gin_channels=8), flat)
        out = ours(t(x), t(mask), t(g)).detach().numpy()
        ref = np.asarray(jm.apply(variables, x, mask, g=g))
        np.testing.assert_allclose(out * mask[..., 0], ref * mask[..., 0], atol=ATOL)

    def test_energy_predictor(self):
        x, _ = masked_input(C=16)
        g = np.random.RandomState(3).randn(2, 1, 8).astype(np.float32)
        jm = JaxEnergyPredictor(16, gin_channels=8)
        variables, flat = random_params(jm, x, g=g)
        ours = port(EnergyPredictor(16, gin_channels=8), flat)
        # the 768-wide variance stack and two layer norms: 2e-5
        np.testing.assert_allclose(ours(t(x), t(g)).detach().numpy(),
                                   np.asarray(jm.apply(variables, x, g=g)), atol=2e-5)


class TestFlowAndGenerator:
    @pytest.mark.parametrize("with_g", [False, True])
    def test_coupling_reverse(self, with_g):
        """Random (non-zero) ``post`` weights, so the WN stack is visible;
        with and without the speaker conditioning."""
        x, mask = masked_input(T=30, C=16, lengths=(30, 19))
        g = np.random.RandomState(3).randn(2, 1, 8).astype(np.float32)
        jm = JaxCoupling(16, 24, 5, 1, 4, gin_channels=8, mean_only=True)
        variables, flat = random_params(jm, x, mask, g=g)
        ours = port(ResidualCouplingLayer(16, 24, 5, 1, 4, gin_channels=8), flat)
        g = g if with_g else None
        out = ours(t(x), t(mask), g=None if g is None else t(g), reverse=True).detach().numpy()
        ref = np.asarray(jm.apply(variables, x, mask, g=g, reverse=True))
        assert np.abs(ref - x).max() > 0.1
        np.testing.assert_allclose(out, ref, atol=2e-5)

    @pytest.mark.parametrize("fused", [False, True])
    def test_generator(self, fused):
        """Rates (2, 2) from 128 channels: the C = 64 stage exists, so the MRF
        dispatch runs; weight-norm decoder weights at N(0, 0.05²).  Against
        the JAX generator's XLA path and its ``fused`` path (the Pallas MRF
        kernel in interpret mode at C = 64)."""
        r = np.random.RandomState(4)
        x = r.randn(2, 12, 16).astype(np.float32)
        g = r.randn(2, 1, 8).astype(np.float32)
        jm = JaxGenerator("1", (3, 7, 11), ((1, 3, 5),) * 3, (2, 2), 128, (4, 4),
                          gin_channels=8)
        variables, flat = random_params(jm, x, g, scale=0.05)
        ours = port(Generator(16, "1", (3, 7, 11), ((1, 3, 5),) * 3, (2, 2), 128, (4, 4),
                              gin_channels=8), flat)
        out = ours(t(x), t(g)).detach().numpy()
        ref = np.asarray(jm.apply(variables, x, g, fused=fused))
        assert out.shape == ref.shape == (2, 48, 1)
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(out, ref, atol=ATOL)


class TestText:
    def test_symbol_table_matches(self):
        assert symbols == JAX_SYMBOLS
        assert N_SYMBOLS == 519

    @pytest.mark.parametrize("text", ["[P]ni2 hao3 shi4 jie4[P]",
                                      "[P]zhuang1 dianr3 lv4 yue4[P] [P]er2[P]"])
    def test_pinyin_blocks_match(self, text):
        assert text_to_phones(text) == jax_cleaner.text_to_phones(text)
        assert (cleaned_text_to_sequence(text_to_phones(text))
                == jax_cleaner.text_to_sequence(text))

    @pytest.mark.parametrize("text,frontend", [("你好", "Mandarin G2P"),
                                               ("[EN]hello[EN]", "English G2P"),
                                               ("[P]ni2[P] hello", "English G2P")])
    def test_text_outside_pinyin_names_missing_frontend(self, text, frontend):
        """With no G2P package and no lexicon loaded, text outside a [P]
        block raises the JAX package's FrontendUnavailable, naming the
        backend it lacks."""
        with pytest.raises(RuntimeError, match=frontend) as ours:
            text_to_phones(text)
        with pytest.raises(RuntimeError, match=frontend) as ref:
            jax_cleaner.text_to_phones(text)
        assert type(ours.value).__name__ == type(ref.value).__name__ == "FrontendUnavailable"
        assert str(ours.value) == str(ref.value)


class TestWeightBridge:
    @pytest.mark.parametrize("fault,message", [
        ("extra_leaf", r"unmapped flax leaves \['stray.weight'\]"),
        ("missing_leaf", r"unfilled port keys \['bias'\]"),
        ("bad_shape", r"shape mismatches \['weight_v"),
    ])
    def test_fails_loudly(self, fault, message):
        x, _ = masked_input()
        _, flat = random_params(jax_layers.WNConv1d(20, 7), x)
        if fault == "extra_leaf":
            flat["stray/kernel"] = np.zeros((1, 1, 1), np.float32)
        elif fault == "missing_leaf":
            flat.pop("bias")
        else:
            flat["v"] = flat["v"][:, :10]
        with pytest.raises(ValueError, match=message):
            load_flax_params(layers.WNConv1d(16, 20, 7), flat)
