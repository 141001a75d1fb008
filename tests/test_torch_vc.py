"""The port's voice conversion against the JAX package at small widths:
``Synthesizer.voice_conversion``, ``TTSEngine.voice_conversion``, the path's
kernel wrappers, and kernel B's plain version at the posterior encoder's
depth (L = 16, k = 5), which its per-layer mode serves on the card.

Weights: every flax leaf drawn from numpy, carried by
``utils/jax_weights.py``.  Noise: JAX draws the posterior noise from its
``sample`` stream; the port takes it as ``eps``, recovered from JAX's own
posterior as eps = (z − m)·e^(−logs) on the valid frames.

Tolerances: latents to 1e-5 of their peak (at least 1e-5 absolute; f32
summation order through 16 + 8 WN layers, and the posterior's values reach
~40 here), audio to 1e-4 (as ``test_torch_synthesizer.py``: it passes the
flows, 2 upsampling stages and 36 convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.data.dataset import numpy_spectrogram as jax_numpy_spectrogram
from vispeech_tpu.infer.pipeline import TTSEngine as JaxEngine
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.ops.pallas.wn_stack import wn_stack as jax_wn_stack
from vispeech_tpu.ops.policy import FLOAT32_XLA
from vispeech_tpu.text.symbols import N_SYMBOLS as JAX_N_SYMBOLS
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.infer.batching import pick_bucket
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.ops.kernels import mrf_stage, mrf_stage_folded, wn_stack
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.utils.jax_weights import load_flax_params

HOP = 4
CFG = {
    "train": {"segment_size": 4 * HOP, "fp16_run": False},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": HOP,
             "win_length": 16, "n_speakers": 4, "spk2id": {"alice": 1, "bob": 2}},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "upsample_rates": [2, 2],
              "upsample_initial_channel": 128, "upsample_kernel_sizes": [4, 4],
              "gin_channels": 8},
}
ATOL, AUDIO_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config_from_dict(CFG)
    jm = JaxSynthesizer.from_config(jcfg, JAX_N_SYMBOLS, policy=FLOAT32_XLA)
    B, N, T = 1, 8, 16
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.ones((B, N), jnp.int32), jnp.asarray([N]), jnp.full((B, N), 150.0),
        jnp.full((B, N), 60.0), jnp.full((B, N), 2, jnp.int32),
        jnp.zeros((B, T, jcfg.data.spec_channels)), jnp.asarray([T]),
        jnp.zeros((B,), jnp.int32), deterministic=True))["params"]
    r = np.random.RandomState(10)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        else:
            a = a * (0.05 if name.startswith("dec/") else 0.2)
        flat[name] = a.astype(np.float32)
    variables = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    pcfg = config_from_dict(CFG)
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_SYMBOLS), flat).eval()
    return {"jcfg": jcfg, "jm": jm, "variables": variables, "pcfg": pcfg, "pm": pm}


def _wav(n_frames, seed=0):
    r = np.random.RandomState(seed)
    n = np.arange(n_frames * HOP)
    return (0.5 * np.sin(2 * np.pi * 440 * n / 8000) + 0.1 * r.randn(len(n))).astype(np.float32)


def _jax_vc(models, spec, lengths, src, tgt, key=0):
    """JAX's voice conversion with its own noise, and that noise recovered
    from its posterior: → (outputs, eps)."""
    jm = models["jm"]

    def run(variables, spec, lengths, src, tgt):
        def posterior(m):
            return m.enc_q(spec, lengths, g=m.emb_g(src)[:, None, :])

        out = jm.apply(variables, spec, lengths, src, tgt,
                       method=JaxSynthesizer.voice_conversion,
                       rngs={"sample": jax.random.PRNGKey(key)})
        return out, jm.apply(variables, method=posterior, rngs={"sample": jax.random.PRNGKey(99)})

    out, (_, m, logs, mask) = jax.jit(run)(models["variables"], *map(jnp.asarray, (
        spec, lengths, src, tgt)))
    z, m, logs, mask = (np.asarray(a, np.float64) for a in (out[2][0], m, logs, mask))
    eps = np.where(mask > 0, (z - m) * np.exp(-logs), 0.0).astype(np.float32)
    return out, eps


def _spec_batch(seed=0):
    spec = np.stack([jax_numpy_spectrogram(_wav(24, seed + i), 16, HOP, 16)[:24]
                     for i in range(2)])
    lengths = np.array([24, 19])
    spec[1, 19:] = 0.0
    return spec, lengths


class TestVoiceConversion:
    def test_synthesizer_matches_jax(self, models):
        spec, lengths = _spec_batch()
        src, tgt = np.array([1, 3]), np.array([2, 0])
        ref, eps = _jax_vc(models, spec, lengths, src, tgt)
        t = [torch.from_numpy(a) for a in (spec, lengths, src, tgt)]
        audio, y_mask, latents = models["pm"].voice_conversion(*t, eps=torch.from_numpy(eps))
        np.testing.assert_array_equal(y_mask.numpy(), np.asarray(ref[1]))
        for name, ours, want in zip(("z", "z_p", "z_hat"), latents, ref[2]):
            want = np.asarray(want)
            np.testing.assert_allclose(ours.numpy(), want, rtol=0,
                                       atol=ATOL * max(1.0, np.abs(want).max()), err_msg=name)
        assert audio.shape == (2, 24 * HOP, 1) and audio.dtype == torch.float32
        assert np.abs(np.asarray(ref[0])).max() > 0.05
        np.testing.assert_allclose(audio.numpy(), np.asarray(ref[0]), rtol=0, atol=AUDIO_ATOL)

    def test_engine_matches_jax(self, models):
        """The engines on one wav: spectrogram, the 64-frame bucket, speakers
        by name and by id.  JAX's engine draws its noise from PRNGKey(0)."""
        wav = _wav(37, seed=5)
        jax_engine = JaxEngine(models["jcfg"], models["variables"], policy=FLOAT32_XLA,
                               transfer_int16=False)
        ref = jax_engine.voice_conversion(wav, "alice", 3)
        spec = jax_numpy_spectrogram(wav, 16, HOP, 16)
        t = spec.shape[0]
        padded = np.zeros((1, pick_bucket(t), spec.shape[1]), np.float32)
        padded[0, :t] = spec
        _, eps = _jax_vc(models, padded, np.array([t]), np.array([1]), np.array([3]))
        ours = TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu",
                         transfer_int16=False)
        out = ours.voice_conversion(wav, "alice", 3, eps=eps)
        assert out["sampling_rate"] == ref["sampling_rate"] == 8000
        assert out["audio"].dtype == np.float32 and len(out["audio"]) == t * HOP
        np.testing.assert_allclose(out["audio"], ref["audio"], rtol=0, atol=AUDIO_ATOL)
        # without eps the noise comes from a fixed seed: reproducible, and real noise
        a = ours.voice_conversion(wav, "alice", 3)["audio"]
        np.testing.assert_array_equal(a, ours.voice_conversion(wav, "alice", 3)["audio"])
        assert np.abs(a - out["audio"]).max() > 1e-4

    def test_path_calls_the_kernel_wrappers(self, models, monkeypatch):
        """VC reaches kernel B once for the posterior encoder (its per-layer
        mode on the card) and once per coupling each way, C at the C = 64
        stage and D at the C = 32 stage, only through their wrappers."""
        calls = {}
        for mod, name in ((wn_stack, "wn_stack"), (mrf_stage, "mrf_stack"),
                          (mrf_stage_folded, "mrf_stack_folded")):
            def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
        spec, lengths = _spec_batch(seed=3)
        t = [torch.from_numpy(a) for a in (spec, lengths, np.array([1, 2]), np.array([3, 0]))]
        models["pm"].voice_conversion(*t, generator=torch.Generator().manual_seed(0))
        assert calls == {"wn_stack": 1 + 4 + 4, "mrf_stack": 1, "mrf_stack_folded": 1}


def test_wn_stack_plain_at_posterior_depth_matches_pallas():
    """Kernel B's plain version at L = 16, k = 5 (the depth its per-layer
    mode serves) against the Pallas kernel in interpret mode, speaker cond
    per item; 2e-5 (16 layers of f32 summation order)."""
    r = np.random.RandomState(7)
    B, T, C, L, K = 2, 40, 32, 16, 5
    mask = (np.arange(T)[None, :] < np.array([T, 29])[:, None]).astype(np.float32)[..., None]
    w_rs = (r.randn(L, C, 2 * C) * 0.1).astype(np.float32)
    w_rs[-1, :, C:] = 0.0
    b_rs = (r.randn(L, 1, 2 * C) * 0.1).astype(np.float32)
    b_rs[-1, :, C:] = 0.0
    inputs = (r.randn(B, T, C).astype(np.float32), mask,
              (r.randn(B, L, 2 * C) * 0.1).astype(np.float32),
              (r.randn(L, K, C, 2 * C) * 0.05).astype(np.float32), w_rs, b_rs)
    ref = np.asarray(jax_wn_stack(*map(jnp.asarray, inputs), K, interpret=True))
    before = wn_stack.launches
    out = wn_stack.wn_stack(*(torch.from_numpy(a) for a in inputs), K).numpy()
    assert wn_stack.launches == before
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
