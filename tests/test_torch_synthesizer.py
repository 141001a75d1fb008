"""The port's inference slice against the JAX package at small widths:
``Synthesizer.infer_prior`` / ``infer``, ``TTSEngine.synthesize`` /
``synthesize_batch``, checkpoint loading and the device contract.

Weights: every flax leaf drawn from numpy (shapes from ``eval_shape``),
carried by ``utils/jax_weights.py``.  The duration head's projection is
biased so predicted durations land at a few frames.  Noise: the prior noise
is injected (``eps``) or switched off (``noise_scale=0``), since JAX and
torch random streams differ.

Duration trap: ``ceil`` of a predicted duration that sits within rounding
of an integer can flip and shift all the audio by a frame.  So ``logw`` is
compared with a tolerance, audio is compared at explicit durations, and
where predicted durations drive the audio the test first checks that every
one is at least 1e-3 away from an integer.

Tolerances: the prior to 1e-5 (absolute and relative: summation order in
f32).  f0 [Hz] = 700·(10^(lf0·500/2590) − 1) and energy = 36·e + 60 scale
an error of 1e-5 in the network's output by 311·(1 + f0/700) and by 36, so
f0 is held to 1e-4 relative plus 5e-3 Hz and energy to 4e-4 absolute.  Audio to 1e-4: it
passes the flow, 2 upsampling stages and 36 convolutions.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.infer.pipeline import TTSEngine as JaxEngine
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.ops.policy import FLOAT32_XLA
from vispeech_tpu.text.symbols import N_SYMBOLS as JAX_N_SYMBOLS
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.infer.batching import plan_batches
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops import policy as port_policy
from vispeech_tpu_torch.text import N_SYMBOLS, cleaned_text_to_sequence
from vispeech_tpu_torch.utils.jax_weights import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
TEXTS = ["[P]ni2 hao3 shi4 jie4[P]", "[P]zai4 jian4[P]", "[P]wo3 men5 zou3 ba5 hao3 de5[P]"]
ATOL, AUDIO_ATOL = 1e-5, 1e-4
F0_RTOL, F0_ATOL, ENERGY_ATOL = 1e-4, 5e-3, 4e-4


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
    r = np.random.RandomState(0)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        elif name.startswith("dec/"):
            a = a * 0.05
        else:
            a = a * 0.2
        flat[name] = a.astype(np.float32)
    flat["duration_predictor/proj/kernel"] *= 0.2
    flat["duration_predictor/proj/bias"][:] = 1.6
    variables = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    pcfg = config_from_dict(CFG)
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_SYMBOLS), flat).eval()
    return {"jcfg": jcfg, "jm": jm, "variables": variables, "flat": flat,
            "pcfg": pcfg, "pm": pm}


def _batch(seed=0):
    r = np.random.RandomState(seed)
    ph = r.randint(1, N_SYMBOLS, (2, 12))
    lens = np.array([12, 9])
    ph[1, 9:] = 0
    dur = r.randint(1, 6, (2, 12)).astype(np.float32)
    dur[1, 9:] = 0
    return ph, lens, np.array([1, 3]), dur


def _t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


def _away_from_integers(values, margin=1e-3):
    v = np.asarray(values, np.float64)
    return np.all(np.abs(v - np.round(v)) > margin)


class TestSynthesizer:
    def test_infer_prior(self, models):
        ph, lens, sid, dur = _batch()
        eps = np.random.RandomState(1).randn(2, 64, 16).astype(np.float32)
        kw = dict(noise_scale=0.7, pitch_control=1.1, energy_control=0.9)
        ref = models["jm"].apply(
            models["variables"], jnp.asarray(ph), jnp.asarray(lens), 64,
            sid=jnp.asarray(sid), duration_control=jnp.asarray(dur), eps=jnp.asarray(eps),
            method=JaxSynthesizer.infer_prior, **kw)
        out = models["pm"].infer_prior(_t(ph), _t(lens), 64, sid=_t(sid),
                                       duration_control=_t(dur), eps=_t(eps), **kw)
        z_p, mask, d, f0, energy = (o.numpy() for o in out[:5])
        np.testing.assert_array_equal(mask, np.asarray(ref[1]))
        np.testing.assert_array_equal(d, np.asarray(ref[2]))
        np.testing.assert_allclose(z_p, np.asarray(ref[0]), rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(f0, np.asarray(ref[3]), rtol=F0_RTOL, atol=F0_ATOL)
        np.testing.assert_allclose(energy, np.asarray(ref[4]), rtol=0, atol=ENERGY_ATOL)

    def test_infer_audio(self, models):
        ph, lens, sid, dur = _batch(seed=2)
        eps = np.random.RandomState(3).randn(2, 64, 16).astype(np.float32)
        ref = jax.jit(lambda v, e: models["jm"].apply(
            v, jnp.asarray(ph), jnp.asarray(lens), 64, sid=jnp.asarray(sid),
            duration_control=jnp.asarray(dur), eps=e, method=JaxSynthesizer.infer))(
            models["variables"], jnp.asarray(eps))
        out = models["pm"].infer(_t(ph), _t(lens), 64, sid=_t(sid),
                                 duration_control=_t(dur), eps=_t(eps))
        audio = out[0].numpy()
        assert audio.shape == (2, 64 * HOP, 1)
        assert np.abs(np.asarray(ref[0])).max() > 0.05
        np.testing.assert_allclose(audio, np.asarray(ref[0]), rtol=0, atol=AUDIO_ATOL)
        np.testing.assert_allclose(out[2][0].numpy(), np.asarray(ref[2][0]), atol=ATOL)

    def test_predicted_durations(self, models):
        ph, lens, sid, _ = _batch()
        jm, pm = models["jm"], models["pm"]

        def jax_logw(m):
            x, x_mask = m.enc_p(jnp.asarray(ph), jnp.asarray(lens))
            return m.duration_predictor(x, x_mask, g=m._speaker(jnp.asarray(sid)))

        logw = np.asarray(jm.apply(models["variables"], method=jax_logw))
        with torch.no_grad():
            x, x_mask = pm.enc_p(_t(ph), _t(lens))
            ours = pm.duration_predictor(x, x_mask, g=pm._speaker(_t(sid))).numpy()
        np.testing.assert_allclose(ours, logw, rtol=0, atol=ATOL)
        w = np.exp(logw[..., 0]) - 1.0
        assert _away_from_integers(w[lens[:, None] > np.arange(12)])
        pred = pm.predict_durations(_t(ph), _t(lens), sid=_t(sid)).numpy()
        ref = np.asarray(jm.apply(models["variables"], jnp.asarray(ph), jnp.asarray(lens),
                                  sid=jnp.asarray(sid),
                                  method=JaxSynthesizer.predict_durations))
        np.testing.assert_array_equal(pred, ref)
        assert 1 <= pred[0].min() and pred.max() < 20


@pytest.fixture(scope="module")
def engines(models):
    jax_engine = JaxEngine(models["jcfg"], models["variables"], policy=FLOAT32_XLA,
                           transfer_int16=False)
    ours = TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu",
                     transfer_int16=False)
    return jax_engine, ours


def _compare(out, ref):
    assert out["phones"] == list(ref["phones"])
    np.testing.assert_array_equal(out["duration"], ref["duration"])
    assert len(out["audio"]) == int(out["duration"].sum()) * HOP
    np.testing.assert_allclose(out["f0"], ref["f0"], rtol=F0_RTOL, atol=F0_ATOL)
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=0, atol=ENERGY_ATOL)
    np.testing.assert_allclose(out["audio"], ref["audio"], rtol=0, atol=AUDIO_ATOL)


class TestEngine:
    def test_synthesize_array_controls(self, engines):
        jax_engine, ours = engines
        n = len(ours.phonemes(TEXTS[0]))
        r = np.random.RandomState(5)
        kw = dict(text=TEXTS[0], speaker="alice", noise_scale=0.0,
                  duration_control=r.randint(2, 7, n).astype(np.float32),
                  pitch_control=r.uniform(120, 260, n), energy_control=r.uniform(40, 80, n))
        _compare(ours.synthesize(**kw), jax_engine.synthesize(**kw))

    def test_synthesize_scalar_controls(self, engines, models):
        jax_engine, ours = engines
        kw = dict(text=TEXTS[2], speaker=2, noise_scale=0.0, duration_control=1.5,
                  pitch_control=0.9, energy_control=1.2)
        ref = jax_engine.synthesize(**kw)
        out = ours.synthesize(**kw)
        _compare(out, ref)
        assert out["duration"].sum() > len(out["phones"])

    def test_synthesize_batch(self, engines):
        jax_engine, ours = engines
        kw = dict(texts=TEXTS, speakers=[0, "bob", 3], noise_scale=0.0)
        refs = jax_engine.synthesize_batch(**kw)
        outs = ours.synthesize_batch(**kw)
        assert len(outs) == 3
        for out, ref in zip(outs, refs):
            _compare(out, ref)

    def test_int16_pcm_is_rounded_audio(self, models, engines):
        _, ours = engines
        pcm_engine = TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu",
                               transfer_int16=True)
        kw = dict(text=TEXTS[1], noise_scale=0.5, seed=3)
        wav = ours.synthesize(**kw)["audio"]
        out = pcm_engine.synthesize(**kw)
        expect = np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
        assert out["audio_int16"].dtype == np.int16
        np.testing.assert_array_equal(out["audio_int16"], expect)
        np.testing.assert_allclose(out["audio"], expect / 32767.0, atol=1e-7)

    def test_from_checkpoint_and_cli(self, models, engines, tmp_path):
        """A ckpt_1.npz in the JAX trainer's layout (params_g/params/..., plus
        discriminator and optimizer arrays that loading skips)."""
        import json

        arrays = {f"params_g/params/{k}": v for k, v in models["flat"].items()}
        arrays["params_d/params/conv/kernel"] = np.zeros((3, 1, 4), np.float32)
        arrays["step"] = np.asarray(1)
        np.savez(tmp_path / "ckpt_1.npz", **arrays)
        config_path = tmp_path / "config.json"
        config_path.write_text(json.dumps(CFG))
        engine = TTSEngine.from_checkpoint(str(config_path), str(tmp_path), device="cpu",
                                           transfer_int16=False)
        for k, v in models["pm"].state_dict().items():
            torch.testing.assert_close(engine.model.state_dict()[k], v, rtol=0, atol=0)
        kw = dict(text=TEXTS[0], noise_scale=0.0)
        np.testing.assert_array_equal(engine.synthesize(**kw)["audio"],
                                      engines[1].synthesize(**kw)["audio"])

        wav = tmp_path / "out.wav"
        proc = subprocess.run(
            [sys.executable, "-m", "vispeech_tpu_torch.infer.cli", "-c", str(config_path),
             "-k", str(tmp_path), "-t", TEXTS[1], "-o", str(wav), "--device", "cpu"],
            capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert proc.returncode == 0, proc.stderr
        from scipy.io import wavfile

        sr, data = wavfile.read(wav)
        assert sr == 8000 and data.dtype == np.int16 and len(data) > 0


# six short requests and one long: with tiers (2, 1), three plans at one
# bucket and one at another
PIPELINE_TEXTS = TEXTS * 2 + ["[P]" + " ".join(["ni2 hao3"] * 12) + "[P]"]
PIPELINE_TIERS = (2, 1)


@pytest.fixture(scope="module")
def pcm_engine(models):
    return TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu",
                     transfer_int16=True)


def _plan_by_plan(engine, texts, speakers, seed, noise_scale=0.667):
    """``synthesize_batch`` written out as a plain loop: a duration pass per
    phoneme padding, then each plan staged, inferred and fetched before the
    next, the noise from one generator → [(int16, duration, f0, energy)]."""
    model = engine.model
    ids = [cleaned_text_to_sequence(engine.phonemes(t)) for t in texts]
    n_list = [len(x) for x in ids]
    pads = [-(-n // 32) * 32 for n in n_list]
    durs = [None] * len(texts)
    for pad in sorted(set(pads)):
        idxs = [i for i, p in enumerate(pads) if p == pad]
        ph = np.zeros((len(idxs), pad), np.int64)
        for r, i in enumerate(idxs):
            ph[r, :n_list[i]] = ids[i]
        pred = model.predict_durations(_t(ph), _t([n_list[i] for i in idxs]),
                                       sid=_t([speakers[i] for i in idxs])).numpy()
        for r, i in enumerate(idxs):
            durs[i] = np.ceil(np.maximum(pred[r], 0.0)).astype(np.float32)
            durs[i][n_list[i]:] = 0
    totals = [max(int(d.sum()), 1) for d in durs]
    gen = torch.Generator().manual_seed(seed)
    out = [None] * len(texts)
    plans = plan_batches(totals, tiers=PIPELINE_TIERS)
    for plan in plans:
        pad = max(pads[i] for i in plan.indices)
        ph = np.zeros((plan.tier, pad), np.int64)
        lens = np.ones(plan.tier, np.int64)
        dur = np.zeros((plan.tier, pad), np.float32)
        sid = np.zeros(plan.tier, np.int64)
        for r, i in enumerate(plan.indices):
            ph[r, :n_list[i]] = ids[i]
            lens[r] = n_list[i]
            dur[r, :len(durs[i])] = durs[i]
            sid[r] = speakers[i]
        audio, _, _, d, f0, energy = model.infer(
            _t(ph), _t(lens), plan.bucket, sid=_t(sid), noise_scale=noise_scale,
            duration_control=_t(dur), generator=gen)
        pcm = torch.round(torch.clamp(audio[..., 0], -1.0, 1.0) * 32767.0).to(torch.int16)
        for r, i in enumerate(plan.indices):
            n = n_list[i]
            out[i] = (pcm[r, :totals[i] * HOP].numpy(), d[r, :n].numpy(),
                      f0[r, :n].numpy(), energy[r, :n].numpy())
    return out, plans


def _snapshot(results):
    return [{k: np.array(r[k]) for k in ("audio", "audio_int16", "duration", "f0", "energy")}
            for r in results]


def _assert_same(results, snapshot):
    assert len(results) == len(snapshot)
    for r, s in zip(results, snapshot):
        for k, v in s.items():
            assert r[k].dtype == v.dtype, k
            np.testing.assert_array_equal(r[k], v, err_msg=k)


class TestBatchPipeline:
    """``synthesize_batch`` issues plan k + 1 before it waits on plan k: the
    same plans, padding and noise draws, so the same bits as the plain loop;
    results own their memory; a call that raises leaves the engine whole."""

    SPEAKERS = [0, 1, 2, 3, 1, 0, 2]

    def _call(self, engine, texts=PIPELINE_TEXTS, seed=11):
        return engine.synthesize_batch(texts=texts, speakers=self.SPEAKERS[:len(texts)],
                                       noise_scale=0.667, seed=seed, tiers=PIPELINE_TIERS)

    def test_bit_equal_to_the_plan_loop(self, pcm_engine):
        ref, plans = _plan_by_plan(pcm_engine, PIPELINE_TEXTS, self.SPEAKERS, seed=11)
        assert len(plans) >= 4 and len({p.bucket for p in plans}) >= 2
        out = self._call(pcm_engine)
        for r, (pcm, d, f0, energy) in zip(out, ref):
            assert r["audio_int16"].dtype == np.int16
            np.testing.assert_array_equal(r["audio_int16"], pcm)
            np.testing.assert_array_equal(r["audio"], pcm.astype(np.float32) / 32767.0)
            np.testing.assert_array_equal(r["duration"], d)
            np.testing.assert_array_equal(r["f0"], f0)
            np.testing.assert_array_equal(r["energy"], energy)
        assert len({int(abs(r["audio_int16"]).max()) for r in out}) > 1

    def test_results_own_their_memory(self, pcm_engine):
        first = self._call(pcm_engine)
        kept = _snapshot(first)
        self._call(pcm_engine, texts=PIPELINE_TEXTS[::-1][:5], seed=12)
        self._call(pcm_engine, texts=[TEXTS[2]] * 7, seed=13)
        _assert_same(first, kept)
        arrays = [r[k] for r in first for k in ("audio", "audio_int16", "duration", "f0",
                                                "energy")]
        slots = [b.numpy() for slot in pcm_engine._slots for b in slot.buffers.values()]
        assert slots and not any(np.shares_memory(a, b) for a in arrays for b in slots)
        assert not any(np.shares_memory(a, b) for j, a in enumerate(arrays)
                       for b in arrays[j + 1:])

    def test_a_raising_plan_drains(self, pcm_engine, monkeypatch):
        before = _snapshot(self._call(pcm_engine))
        infer = pcm_engine.model.infer
        calls = []

        def third_raises(*args, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("plan 3 failed")
            return infer(*args, **kw)

        monkeypatch.setattr(pcm_engine.model, "infer", third_raises)
        with pytest.raises(RuntimeError, match="plan 3 failed"):
            self._call(pcm_engine)
        monkeypatch.undo()
        assert not pcm_engine._lock.locked()
        _assert_same(self._call(pcm_engine), before)


class TestDeviceAndPolicy:
    def test_engine_refuses_without_cuda(self, models, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTSEngine(models["pcfg"], models["pm"].state_dict())
        engine = TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu")
        assert engine.policy == port_policy.FLOAT32
        assert not engine.transfer_int16

    def test_policy_precision_restores_tf32(self):
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with port_policy.CUDA_SERVING.precision():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        assert port_policy.default_serving_policy(torch.device("cuda")) \
            == port_policy.CUDA_SERVING

    @pytest.mark.parametrize("policy", ["FLOAT32", "CUDA_SERVING"])
    def test_path_always_calls_the_kernel_wrappers(self, models, monkeypatch, policy):
        """Under every policy the modules reach A, B and C only through their
        wrappers, so the tensor's device alone picks kernel or plain version:
        1 encoder layer + 6 pitch layers + 1 frame-prior layer of A, one B per
        coupling, one C for the C = 64 stage."""
        from vispeech_tpu_torch.ops.kernels import mrf_stage, rel_attention, wn_stack

        calls = {}
        for mod, name in ((rel_attention, "relative_self_attention"),
                          (wn_stack, "wn_stack"), (mrf_stage, "mrf_stack")):
            def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
        model = Synthesizer.from_config(models["pcfg"], N_SYMBOLS,
                                        policy=getattr(port_policy, policy))
        model.load_state_dict(models["pm"].state_dict())
        ph, lens, sid, dur = _batch(seed=5)
        model.infer(_t(ph), _t(lens), 64, sid=_t(sid), duration_control=_t(dur),
                    noise_scale=0.0)
        assert calls == {"relative_self_attention": 1 + 6 + 1, "wn_stack": 4,
                         "mrf_stack": 1}

    def test_serving_policy_on_cpu_tensors(self, models):
        """The CUDA policy (bf16 decoder) on CPU tensors: the wrappers take
        their plain versions; audio within bf16 resolution of the f32 run
        (5e-2 of the peak: 8-bit mantissas through 36 convs)."""
        ph, lens, sid, dur = _batch(seed=4)
        eps = np.random.RandomState(6).randn(2, 64, 16).astype(np.float32)
        bf16 = Synthesizer.from_config(models["pcfg"], N_SYMBOLS,
                                       policy=port_policy.CUDA_SERVING)
        bf16.load_state_dict(models["pm"].state_dict())
        args = (_t(ph), _t(lens), 64)
        kw = dict(sid=_t(sid), duration_control=_t(dur), eps=_t(eps))
        ref = models["pm"].infer(*args, **kw)[0]
        out = bf16.infer(*args, **kw)[0]
        assert out.dtype == torch.float32
        assert (out - ref).abs().max() < 5e-2 * ref.abs().max()

    def test_random_init_is_seeded(self, models):
        a = random_init_(Synthesizer.from_config(models["pcfg"], N_SYMBOLS), seed=7)
        b = random_init_(Synthesizer.from_config(models["pcfg"], N_SYMBOLS), seed=7)
        for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.isfinite(p).all(), name
            torch.testing.assert_close(p, q, rtol=0, atol=0)
