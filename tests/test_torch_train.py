"""The port's training slice against the JAX package on the CPU, at
``tests/test_train_step.py``'s tiny configuration: DSP, losses, the
discriminators, the Synthesizer's training forward, the generator and
discriminator gradients of the step's losses, one AdamW update, the weight
bridge for a JAX checkpoint, and the Trainer and its CLI.

Weights: every flax leaf drawn from numpy (shapes from ``eval_shape``) and
carried over by ``utils/jax_weights.py``.  Randomness: JAX runs with
``deterministic=True`` and the port in eval mode (dropout off, gradients
on, so kernels E and F run their plain forward and backward); the
posterior noise is recovered from JAX's (z, m_q, logs_q) and JAX's segment
starts are handed over.

Tolerances (f32, summation order): spectrograms 1e-4 relative; losses and
latents 1e-4 relative + 1e-5; the audio segment 1e-4 absolute; gradients
2e-3 of each parameter's largest gradient (floored at 1e-3 of the
network's largest, for gradients that vanish in exact arithmetic, such as
the key biases'), as they pass the 16-layer posterior WN, 4 couplings, the
decoder and six discriminators; AdamW against optax 1e-6.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.dsp import mel_spectrogram as jax_mel, spectrogram as jax_spec
from vispeech_tpu.models import MultiPeriodDiscriminator as JaxMPD
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.ops.masking import length_mask as jax_length_mask
from vispeech_tpu.ops.masking import slice_segments as jax_slice
from vispeech_tpu.train import losses as JL
from vispeech_tpu.train.step import TrainState, make_optimizer as jax_make_optimizer
from vispeech_tpu.utils.checkpoint import _path_str
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.dsp import mel_spectrogram, spectrogram
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.ops import kernels
from vispeech_tpu_torch.train import losses as L
from vispeech_tpu_torch.train.step import TrainStep, make_optimizer
from vispeech_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VOCAB = 40
TINY = {
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False,
              "learning_rate": 2e-4, "c_mel": 45, "c_kl": 1.0},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}
B, N, T, HOP, SEG = 2, 6, 16, 8, 64
REL, ABS = 1e-4, 1e-5


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def make_batch(seed=0):
    r = np.random.RandomState(seed)
    dur = r.randint(1, 4, size=(B, N))
    return dict(
        phonemes=r.randint(1, N_VOCAB, size=(B, N)).astype(np.int32),
        phoneme_lengths=np.array([N, N - 2], np.int32),
        f0=r.uniform(80, 400, (B, N)).astype(np.float32),
        energy=r.uniform(30, 90, (B, N)).astype(np.float32),
        duration=dur.astype(np.int32), spec_lengths=dur.sum(1).astype(np.int32),
        wav=np.clip(r.randn(B, T * HOP, 1) * 0.2, -1, 1).astype(np.float32),
        sid=np.array([0, 2], np.int32))


def random_flat(shapes, r, scale=0.3):
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape) * scale
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        flat[name] = a.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    jcfg = jax_config_from_dict(TINY)
    pcfg = config_from_dict(TINY)
    b = make_batch()
    d = jcfg.data
    wav = jnp.asarray(b["wav"])
    spec = jax_spec(wav[..., 0], d.filter_length, d.sampling_rate, d.hop_length, d.win_length)
    spec = spec * jax_length_mask(jnp.asarray(b["spec_lengths"]), spec.shape[1])
    args = tuple(jnp.asarray(b[k]) for k in ("phonemes", "phoneme_lengths", "f0", "energy",
                                             "duration")) + (
        spec, jnp.asarray(b["spec_lengths"]), jnp.asarray(b["sid"]))
    jm = JaxSynthesizer.from_config(jcfg, N_VOCAB)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, *args, deterministic=True))["params"]
    r = np.random.RandomState(0)
    flat_g = random_flat(shapes, r)
    # the decoder's weights stay small, as its initializer keeps them
    flat_g = {k: (v * 0.2 if k.startswith("dec/") and k.endswith("/v") else v)
              for k, v in flat_g.items()}
    jd = JaxMPD()
    dummy = jnp.zeros((B, SEG, 1))
    d_shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(3), dummy, dummy))["params"]
    flat_d = random_flat(d_shapes, r, scale=0.05)
    params_g = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat_g))
    params_d = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat_d))
    sample = jax.random.PRNGKey(7)
    # jitted: one compile of the whole program is faster than eager JAX here
    out = jax.jit(lambda p: jm.apply({"params": p}, *args, deterministic=True,
                                     rngs={"sample": sample}))(params_g)
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_VOCAB), flat_g, 1).eval()
    pd = load_flax_params(MultiPeriodDiscriminator(), flat_d, discriminator=True).eval()
    z, m_q, logs_q = (np.asarray(a) for a in out[7][0:1] + out[7][4:6])
    y_mask = np.asarray(out[6])
    eps = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, batch=b, spec=np.asarray(spec), args=args, jm=jm, jd=jd,
                params_g=params_g, params_d=params_d, sample=sample, out=out, pm=pm, pd=pd,
                eps=eps, ids=np.asarray(out[4]))


def _unflatten(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def port_args(s):
    b = s["batch"]
    return (t(b["phonemes"], torch.long), t(b["phoneme_lengths"], torch.long), t(b["f0"]),
            t(b["energy"]), t(b["duration"], torch.long), t(s["spec"]),
            t(b["spec_lengths"], torch.long), t(b["sid"], torch.long))


def close(got, want, rel=REL, atol=ABS, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rel, atol=atol, err_msg=what)


def test_dsp_matches_jax():
    r = np.random.RandomState(1)
    y = (r.randn(2, 4096) * 0.3).astype(np.float32)
    for n_fft, hop, n_mels, sr in ((16, 8, 8, 8000), (2048, 512, 80, 44100)):
        want = np.asarray(jax_spec(jnp.asarray(y), n_fft, sr, hop, n_fft))
        got = spectrogram(t(y), n_fft, hop, n_fft)
        close(got, want, 1e-4, 1e-5, f"spec n_fft={n_fft}")
        want = np.asarray(jax_mel(jnp.asarray(y), n_fft, n_mels, sr, hop, n_fft, 0.0, None))
        close(mel_spectrogram(t(y), n_fft, n_mels, sr, hop, n_fft, 0.0, None), want, 1e-4, 1e-4,
              f"mel n_fft={n_fft}")


def test_losses_match_jax():
    r = np.random.RandomState(2)
    fr = [[r.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fg = [[r.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    lr_, lg = ([r.randn(2, 7).astype(np.float32) for _ in range(3)] for _ in range(2))
    close(L.feature_loss([[t(a) for a in d] for d in fr], [[t(a) for a in d] for d in fg]),
          JL.feature_loss(fr, fg))
    close(L.discriminator_loss([t(a) for a in lr_], [t(a) for a in lg])[0],
          JL.discriminator_loss(lr_, lg)[0])
    close(L.generator_loss([t(a) for a in lg])[0], JL.generator_loss(lg)[0])
    zs = [r.randn(2, 9, 4).astype(np.float32) * 0.5 for _ in range(4)]
    mask = (np.arange(9)[None, :, None] < np.array([9, 6])[:, None, None]).astype(np.float32)
    close(L.kl_loss(*(t(a) for a in zs), t(mask)), JL.kl_loss(*zs, mask))


def test_discriminator_matches_jax(setup):
    r = np.random.RandomState(3)
    y, y_hat = (np.clip(r.randn(B, SEG, 1) * 0.3, -1, 1).astype(np.float32) for _ in range(2))
    want = jax.jit(setup["jd"].apply)({"params": setup["params_d"]}, y, y_hat)
    got = setup["pd"](t(y), t(y_hat))
    for i, name in enumerate(("real logits", "fake logits")):
        for a, b_ in zip(got[i], want[i]):
            close(a.detach(), b_, 1e-4, 1e-5, name)
    for a, b_ in zip(sum(got[3], []), sum(want[3], [])):
        # NCHW against NHWC: the feature loss reads means of |·|, compare those
        close(a.detach().abs().mean(), np.abs(np.asarray(b_)).mean(), 1e-4, 1e-6, "fmap")


def test_synthesizer_training_forward_matches_jax(setup):
    want = setup["out"]
    with torch.no_grad():
        got = setup["pm"](*port_args(setup), eps_q=t(setup["eps"]), ids_slice=t(setup["ids"]))
    np.testing.assert_array_equal(got[4].numpy(), setup["ids"])
    close(got[0], want[0], 0, 1e-4, "audio segment")
    for i, name in ((1, "l_length"), (2, "l_pitch"), (3, "l_energy")):
        close(got[i], want[i], what=name)
    for name, a, b_ in zip(("z", "z_p", "m_p", "logs_p", "m_q", "logs_q"), got[7], want[7]):
        close(a, b_, what=name)
    close(got[6], want[6], what="y_mask")
    close(got[8], want[8], 1e-4, 1e-3, "pred_f0 [Hz]")


def _jax_step_grads(s, jd, params_d):
    """jax.grad of the step's two losses: D on the detached output, G
    against the same D (the port runs at learning rate 0, so its
    discriminator update leaves D as it was)."""
    jcfg, d = s["jcfg"], s["jcfg"].data
    wav = jnp.asarray(s["batch"]["wav"])
    mel = jax_mel_of_spec(jnp.asarray(s["spec"]), d)

    def forward(pg):
        return s["jm"].apply({"params": pg}, *s["args"], deterministic=True,
                             rngs={"sample": s["sample"]})

    out = s["out"]
    ids = out[4]
    wav_slice = jax_slice(wav, ids * d.hop_length, SEG)

    def d_loss(pd):
        lr_, lg, _, _ = jd.apply({"params": pd}, wav_slice, jax.lax.stop_gradient(out[0]))
        return JL.discriminator_loss(lr_, lg)[0]

    def g_loss(pg, pd):
        y_hat, l_len, l_pitch, l_en, _, _, y_mask, lat, *_ = forward(pg)
        z, z_p, m_p, logs_p, m_q, logs_q = lat
        y_mel = jax_slice(mel, ids, SEG // d.hop_length)
        y_hat_mel = jax_mel(y_hat[..., 0], d.filter_length, d.n_mel_channels, d.sampling_rate,
                            d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)
        _, lg, fr, fg = jd.apply({"params": pd}, wav_slice, y_hat)
        return (JL.generator_loss(lg)[0] + JL.feature_loss(fr, fg)
                + jnp.mean(jnp.abs(y_mel - y_hat_mel)) * jcfg.train.c_mel + l_len
                + JL.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * jcfg.train.c_kl
                + l_pitch + l_en)

    ld, gd = jax.jit(jax.value_and_grad(d_loss))(params_d)
    # D's parameters are arguments, not constants: XLA would fold its convs
    lg_, gg = jax.jit(jax.value_and_grad(g_loss))(s["params_g"], params_d)
    return float(ld), gd, float(lg_), gg


def jax_mel_of_spec(spec, d):
    from vispeech_tpu.dsp import spec_to_mel

    return spec_to_mel(spec, d.filter_length, d.n_mel_channels, d.sampling_rate, d.mel_fmin,
                       d.mel_fmax)


def test_step_gradients_match_jax(setup):
    import dataclasses

    s = setup
    # the scale discriminator and one period keep the JAX compile short
    jd = JaxMPD(periods=(2,))
    params_d = {k: v for k, v in s["params_d"].items() if k in ("disc_s", "disc_p2")}
    ld, gd, lg, gg = _jax_step_grads(s, jd, params_d)
    pcfg = s["pcfg"]
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, learning_rate=0.0))
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_VOCAB),
                          {k: np.asarray(v) for k, v in flatten_dict(
                              jax.device_get(s["params_g"]), sep="/").items()}, 1).eval()
    pd = load_flax_params(MultiPeriodDiscriminator(periods=(2,)),
                          {k: np.asarray(v) for k, v in flatten_dict(
                              jax.device_get(params_d), sep="/").items()},
                          discriminator=True).eval()
    step = TrainStep(pcfg, pm, pd, steps_per_epoch=10)
    args = port_args(s)
    batch = dict(zip(("phonemes", "phoneme_lengths", "f0", "energy", "duration", "spec",
                      "spec_lengths", "sid"), args), wav=t(s["batch"]["wav"]))
    m = step(batch, eps_q=t(s["eps"]), ids_slice=t(s["ids"]))
    close(m["loss/d/total"], ld, what="D loss")
    close(m["loss/g/total"], lg, what="G loss")
    for model, grads, disc in ((pm, gg, False), (pd, gd, True)):
        want = flax_to_state_dict({k: np.asarray(v) for k, v in
                                   flatten_dict(jax.device_get(grads), sep="/").items()},
                                  1, discriminator=disc)
        norm_p = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters()))
        norm_j = torch.sqrt(sum((w.double() ** 2).sum() for w in want.values()))
        close(norm_p, norm_j, 1e-3, 0, "grad norm")
        top = max(float(w.abs().max()) for w in want.values())
        for name, p in model.named_parameters():
            peak = max(float(want[name].abs().max()), 1e-3 * top)
            close(p.grad, want[name], 0, 2e-3 * peak, name)
        norm = "grad_norm_d" if disc else "grad_norm_g"
        close(m[norm], norm_p, 1e-5, 0, norm)


def test_adamw_matches_optax():
    jcfg, pcfg = jax_config_from_dict(TINY), config_from_dict(TINY)
    r = np.random.RandomState(5)
    params = {"a": r.randn(3, 4).astype(np.float32), "b": r.randn(5).astype(np.float32)}
    grads = [{k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_make_optimizer(jcfg, 10)
    p, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(p)
    model = torch.nn.Module()
    for k, v in params.items():
        setattr(model, k, torch.nn.Parameter(t(v)))
    opt = make_optimizer(pcfg, model)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
        for k in params:
            getattr(model, k).grad = t(g[k])
        opt.step()
    for k in params:
        close(getattr(model, k).detach(), p[k], 0, 1e-6, k)


def test_inference_kernels_refuse_autograd():
    """The helper raises only for tensors autograd tracks, with grad mode on."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="wn_stack_train"):
        kernels.refuse_autograd("wn_stack", "wn_stack_train.wn_stack_train", x)
    with torch.no_grad():
        kernels.refuse_autograd("wn_stack", "wn_stack_train.wn_stack_train", x)
    kernels.refuse_autograd("wn_stack", "wn_stack_train.wn_stack_train", x.detach())


def test_jax_checkpoint_resumes_in_the_port(tmp_path, setup):
    """A JAX ``ckpt_*.npz`` (arrays at the key paths ``flatten_state``
    writes) fills both networks and both optimizers' moments."""
    from vispeech_tpu_torch.utils.jax_weights import load_jax_checkpoint

    s = setup
    jcfg = s["jcfg"]
    # the scale discriminator and one period keep the arrays small
    params_d = {k: v for k, v in s["params_d"].items() if k in ("disc_s", "disc_p2")}
    tx = jax_make_optimizer(jcfg, 10)
    state = TrainState(step=jnp.int32(5), params_g={"params": s["params_g"]},
                       params_d={"params": params_d},
                       opt_state_g=jax.eval_shape(tx.init, s["params_g"]),
                       opt_state_d=jax.eval_shape(tx.init, params_d),
                       rng=jnp.zeros((2,), jnp.uint32))
    r = np.random.default_rng(6)
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        shape, dtype = np.shape(leaf), np.dtype(leaf.dtype)
        flat[_path_str(kp)] = (np.asarray(leaf) if not isinstance(leaf, jax.ShapeDtypeStruct)
                               else (np.full(shape, 3, dtype) if dtype.kind in "iu"
                                     else r.standard_normal(shape, np.float32)))
    np.savez(tmp_path / "ckpt_5.npz", **flat)
    pcfg = s["pcfg"]
    pm = Synthesizer.from_config(pcfg, N_VOCAB)
    pd = MultiPeriodDiscriminator(periods=(2,))
    opt_g, opt_d = make_optimizer(pcfg, pm), make_optimizer(pcfg, pd)
    assert load_jax_checkpoint(str(tmp_path), pm, pd, opt_g, opt_d, 1) == 5
    mu = flax_to_state_dict({k[len("opt_state_d/0/mu/"):]: v for k, v in flat.items()
                             if k.startswith("opt_state_d/0/mu/")}, 1, discriminator=True)
    p = pd.discriminators[1].convs[2].weight_v
    torch.testing.assert_close(opt_d.state[p]["exp_avg"], mu["discriminators.1.convs.2.weight_v"])
    assert float(opt_g.state[pm.enc_q.proj.weight]["step"]) == 3
    torch.testing.assert_close(pm.flow.flows[2].enc.in_layers[0].weight_v.detach(),
                               s["pm"].flow.flows[2].enc.in_layers[0].weight_v.detach())
    # an array the port cannot place fails the load
    np.savez(tmp_path / "ckpt_6.npz", **flat, extra=np.zeros(1))
    with pytest.raises(ValueError, match="extra"):
        load_jax_checkpoint(str(tmp_path), pm, pd, opt_g, opt_d, 1)


def _workspace(root):
    sys.path.insert(0, ROOT)
    from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset

    tr, va, data_root = write_synthetic_dataset(str(root), sr=8000, hop=HOP, n_utts=6,
                                                n_phones=5, dur_range=(2, 4))
    cfg = json.loads(json.dumps(TINY))
    cfg["train"].update(log_interval=1, eval_interval=100, save_dir=str(root / "run"))
    cfg["data"].update(training_files=tr, validation_files=va)
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path), data_root


def test_trainer_steps_saves_and_resumes(tmp_path):
    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.train.loop import Trainer

    cfg_path, data_root = _workspace(tmp_path)
    cfg = load_config(cfg_path)
    tr = Trainer(cfg, data_root=data_root, device="cpu")
    assert tr.resume() is None
    w0 = tr.model_g.dec.conv_post.weight.detach().clone()
    d0 = tr.model_d.discriminators[0].conv_post.weight_v.detach().clone()
    tr.train(max_steps=2)
    assert tr.global_step == 2 and (tmp_path / "run" / "ckpt_2.pt").exists()
    assert not torch.equal(w0, tr.model_g.dec.conv_post.weight)
    assert not torch.equal(d0, tr.model_d.discriminators[0].conv_post.weight_v)
    fresh = Trainer(cfg, data_root=data_root, device="cpu")
    assert fresh.resume() == 2
    torch.testing.assert_close(fresh.model_g.state_dict(), tr.model_g.state_dict())
    fresh.train(max_steps=3)
    assert fresh.global_step == 3 and (tmp_path / "run" / "ckpt_3.pt").exists()
    stats = json.loads((tmp_path / "run" / "train_stats.json").read_text())
    assert stats["global_step"] == 3


def test_cli_trains_on_cpu_and_refuses_what_waits(tmp_path, capsys):
    from vispeech_tpu_torch.train import cli

    cfg_path, data_root = _workspace(tmp_path)
    args = ["-c", cfg_path, "--data-root", data_root, "--max-steps", "2", "--device", "cpu"]
    cli.main(args)
    assert (tmp_path / "run" / "ckpt_2.pt").exists()
    cli.main(args[:-3] + ["3", "--device", "cpu"])   # resumes from ckpt_2.pt
    assert (tmp_path / "run" / "ckpt_3.pt").exists()
    for extra, word in ((["--model-parallel", "2"], "queue 1 item 7"),
                        (["--profile", "1:2"], "queue 1 item 9")):
        with pytest.raises(SystemExit) as exc:
            cli.main(args + extra)
        assert exc.value.code != 0 and word in capsys.readouterr().err


def test_host_spectrogram_batches_match_device_dsp(tmp_path):
    """``device_dsp: false`` collates host spectrograms; they equal what the
    train step computes on the device from the int16 batch, except each
    utterance's last frame, whose window the host reflects at the
    utterance's end and the device sees the batch's zero padding (as in
    the JAX package)."""
    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.data.dataset import FilelistDataset, collate

    cfg_path, data_root = _workspace(tmp_path)
    cfg = load_config(cfg_path)
    ds = FilelistDataset(cfg.data.training_files, cfg.data, data_root)
    host = collate(ds, [0, 3], 64, device_dsp=False)
    dev = collate(ds, [0, 3], 64, device_dsp=True)
    d = cfg.data
    wav = t(dev["wav"]).float() / d.max_wav_value
    spec = spectrogram(wav[..., 0], d.filter_length, d.hop_length, d.win_length)
    mask = np.arange(64)[None, :, None] < dev["spec_lengths"][:, None, None] - 1
    close(host["spec"] * mask, spec.numpy() * mask, 1e-4, 1e-5, "host spec")
    close(host["wav"], wav.numpy(), 0, 0, "host wav")
