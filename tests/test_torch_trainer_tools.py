"""The port's trainer tools and the Trainer's run directory against the JAX
package on the CPU, at ``tests/test_torch_train.py``'s tiny configuration.

* ``utils/flops.py``: ``roofline_row`` equals the JAX function on the same
  inputs; ``model_cost`` counts 2·M·K·N for a product (as
  ``tests/test_flops.py`` asserts of XLA's count) and both directions of a
  convolution; ``chip_peaks`` is None on the CPU and the H100's published
  dense peaks for its name.
* ``utils/logging.py``: ``TrainLogger`` with the JSON-lines writer (no
  tensorboardX) records the same tags, steps and values as the JAX one;
  unlike it, it still writes the audio (to WAV files).
* ``utils/plotting.py``: images of the JAX package's shapes and dtype.
* ``utils/profiling.py``: ``device_memory_stats()`` is ``{}`` on the CPU, as
  the JAX function's is.
* The Trainer: ``config.json`` (``load_config`` reads back the Config),
  ``githash``, ``tb/`` scalars at every ``log_interval`` step with the JAX
  step's metric names plus ``lr`` and ``steps_per_sec``, ``tb_eval/``
  images and audio at ``eval_interval``; with matplotlib absent an eval
  still writes its audio; a run with an eval ends bit-equal to one without
  (through the CLI, with a profiled step);
  the run directory serves through ``TTSEngine.from_checkpoint``.
* The eval synthesis at noise scale 0 against JAX's ``infer`` on the same
  weights: frame count equal, audio within 1e-4 (as
  ``tests/test_torch_synthesizer.py``, whose duration trap this test
  checks first).
* The CLI's ``--profile 1:2`` writes a trace of step 1; ``--profile 1``
  fails with the JAX CLI's words.
"""

import dataclasses
import glob
import json
import os
import shutil
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.ops.policy import FLOAT32_XLA
from vispeech_tpu.train import cli as jax_cli
from vispeech_tpu.train.step import Batch, TrainState, make_optimizer, make_train_step
from vispeech_tpu.utils import flops as jflops
from vispeech_tpu.utils import logging as jlogging
from vispeech_tpu.utils import plotting as jplotting
from vispeech_tpu.utils import profiling as jprofiling
from vispeech_tpu_torch.config import load_config
from vispeech_tpu_torch.data.dataset import FilelistDataset
from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.train import cli
from vispeech_tpu_torch.train.loop import Trainer, synthesize_utterance
from vispeech_tpu_torch.utils import flops, plotting, profiling
from vispeech_tpu_torch.utils import logging as plogging
from vispeech_tpu_torch.utils.jax_weights import load_flax_params

HOP = 8
TINY = {   # tests/test_torch_train.py's
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False,
              "learning_rate": 2e-4, "c_mel": 45, "c_kl": 1.0},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": HOP, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}
AUDIO_ATOL = 1e-4
H100 = {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread in this worker: xdist runs several workers on the
    machine's cores, and oversubscribed, the native CPU convs of a bf16
    discriminator step (oneDNN off) wait at a barrier per group."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def workspace(root, **train):
    tr, va, data_root = write_synthetic_dataset(str(root), sr=8000, hop=HOP, n_utts=6,
                                                n_phones=5, dur_range=(2, 4))
    raw = json.loads(json.dumps(TINY))
    raw["train"].update(dict(log_interval=1, eval_interval=100, save_dir=str(root / "run")),
                        **train)
    raw["data"].update(training_files=tr, validation_files=va)
    path = root / "config.json"
    path.write_text(json.dumps(raw))
    return str(path), data_root


def jax_metric_names():
    """The names of the JAX step's metrics, from tracing it (``jax.
    eval_shape``) with stand-ins for the networks."""
    jcfg = jax_config_from_dict(TINY)
    leaf = {"w": jax.ShapeDtypeStruct((1,), jnp.float32)}

    class Net:
        def apply(self, variables, *args, **kw):
            w = jax.tree_util.tree_leaves(variables)[0].sum() * 0
            if len(args) == 2:   # the discriminators: (y, y_hat)
                x = jnp.zeros((2, 4)) + w
                return [x], [x], [[x]], [[x]]
            spec = args[5]
            z = jnp.zeros((spec.shape[0], spec.shape[1], 8)) + w
            return (jnp.zeros((spec.shape[0], 64, 1)) + w, w, w, w,
                    jnp.zeros((spec.shape[0],), jnp.int32), None,
                    jnp.ones(z.shape[:2] + (1,)), (z,) * 6, None, None, None)

    tx = make_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params_g={"params": leaf},
                       params_d={"params": leaf}, opt_state_g=jax.eval_shape(tx.init, leaf),
                       opt_state_d=jax.eval_shape(tx.init, leaf), rng=jax.random.PRNGKey(0))
    b, n, t = 2, 6, 16
    batch = Batch(phonemes=jnp.ones((b, n), jnp.int32), phoneme_lengths=jnp.full((b,), n),
                  f0=jnp.ones((b, n)), energy=jnp.ones((b, n)),
                  duration=jnp.ones((b, n), jnp.int32), spec=None,
                  spec_lengths=jnp.full((b,), t), wav=jnp.zeros((b, t * HOP, 1), jnp.int16),
                  wav_lengths=jnp.full((b,), t * HOP), sid=jnp.zeros((b,), jnp.int32))
    _, metrics = jax.eval_shape(make_train_step(jcfg, Net(), Net(), 10), state, batch)
    return set(metrics)


def scalar_events(logdir):
    """{tag: [steps]} of the tensorboardX event files in ``logdir``: TFRecord
    frames (length, its CRC, an ``Event`` proto, its CRC)."""
    from tensorboardX.proto.event_pb2 import Event

    out = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            n = struct.unpack("<Q", data[i:i + 8])[0]
            event = Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, []).append(event.step)
    return out


# ---------------------------------------------------------------- utils

@pytest.mark.parametrize("flops_,bytes_,ms,dtype", [
    (1e12, 1e9, 10.0, "bf16"), (1e9, 8e9, 20.0, "f32"), (3.3e11, 2.1e9, 0.7, "bf16"),
    (5e10, 5e10, 0.0, "f32")])
def test_roofline_row_matches_jax(flops_, bytes_, ms, dtype):
    for peaks in (H100, {"bf16_flops": 200e12, "f32_flops": 100e12, "hbm_bytes": 800e9}):
        assert flops.roofline_row(flops_, bytes_, ms, dtype, peaks) == \
            jflops.roofline_row(flops_, bytes_, ms, dtype, peaks)
    # no peaks on the CPU: the row without shares, as JAX's off the TPU
    assert flops.roofline_row(flops_, bytes_, ms, dtype) == \
        jflops.roofline_row(flops_, bytes_, ms, dtype)


def test_model_cost_counts_products():
    M, K, N = 64, 128, 256
    cost = flops.model_cost(lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, N))
    assert cost["flops"] == 2 * M * K * N
    assert cost["bytes"] == 4 * (M * K + K * N + M * N)
    x = torch.randn(2, 8, 100, requires_grad=True)
    w = torch.randn(16, 8, 5, requires_grad=True)
    fwd = 2 * 2 * 16 * 8 * 5 * 96

    def step(x, w):
        torch.nn.functional.conv1d(x, w).sum().backward()

    assert flops.model_cost(step, x, w)["flops"] == 3 * fwd   # forward, dx and dw


def test_chip_peaks(monkeypatch):
    assert flops.chip_peaks() is None and flops.detect_chip() is None
    assert flops.chip_peaks("h100_sxm") == dict(H100, chip="h100_sxm")
    assert flops.chip_peaks("v5e") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, chip in (("NVIDIA H100 80GB HBM3", "h100_sxm"), ("NVIDIA H100 PCIe", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0, n=name: n)
        assert flops.detect_chip() == chip


def _events(logdir):
    with open(os.path.join(logdir, "events.jsonl")) as f:
        return [(e["tag"], e["step"], e["value"]) for e in map(json.loads, f)]


def test_train_logger_fallback_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jlogging, "_TBWriter", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    metrics = {"loss/g/total": np.float32(3.5), "loss/d/total": torch.tensor(1.25),
               "lr": 2e-4, "steps_per_sec": 7.0}
    wav = np.sin(np.arange(800) / 5.0).astype(np.float32) * 0.5
    img = np.zeros((4, 6, 3), np.float32)
    loggers = (jlogging.TrainLogger(str(tmp_path / "jax")),
               plogging.TrainLogger(str(tmp_path / "port")))
    for lg in loggers:
        for step in (1, 2, 5):
            lg.scalars(step, {k: float(v) for k, v in metrics.items()})
        lg.image(5, "eval/mel_gen", img)
        lg.audio(5, "eval/audio_gen", wav, 8000)
        lg.flush()
    assert _events(tmp_path / "port") == _events(tmp_path / "jax")
    assert len(_events(tmp_path / "port")) == 12
    assert not loggers[1].records_media
    # JAX's fallback writer drops the audio; the port's writes it
    assert not os.path.exists(tmp_path / "jax" / "audio")
    from scipy.io import wavfile

    sr, pcm = wavfile.read(tmp_path / "port" / "audio" / "eval_audio_gen_5.wav")
    assert sr == 8000 and np.abs(pcm / 32767 - wav).max() < 1e-4
    for lg in loggers:
        lg.close()


@pytest.mark.parametrize("name,args", [
    ("spectrogram_image", (np.random.RandomState(0).rand(20, 8),)),
    ("line_plot_image", ([np.arange(9.0), np.arange(9.0)[::-1]], ["gt", "pred"], "F0")),
    ("alignment_image", (np.eye(5, 9),)),
])
def test_plots_match_jax(name, args):
    ours, theirs = getattr(plotting, name)(*args), getattr(jplotting, name)(*args)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.uint8
    assert ours.ndim == 3 and ours.shape[-1] == 3


def test_durations_to_alignment_matches_jax():
    for durs, t in (([2, 0, 3, 1], None), ([4, 4], 6)):
        np.testing.assert_array_equal(plotting.durations_to_alignment(durs, t),
                                      jplotting.durations_to_alignment(durs, t))


def test_device_memory_stats_empty_on_cpu():
    assert profiling.device_memory_stats() == jprofiling.device_memory_stats() == {}


# -------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Three CPU steps, an eval at step 2; the directory is removed after
    the module (each checkpoint holds the full-width discriminators)."""
    root = tmp_path_factory.mktemp("trainer_tools")
    cfg_path, data_root = workspace(root, eval_interval=2)
    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, data_root=data_root, device="cpu")
    trainer.train(max_steps=3)
    yield cfg, cfg_path, data_root, trainer
    shutil.rmtree(root, ignore_errors=True)


def test_run_directory(run):
    cfg, _, _, trainer = run
    d = cfg.train.save_dir
    assert load_config(os.path.join(d, "config.json")) == cfg
    head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                          cwd=os.path.dirname(plogging.__file__))
    if head.returncode == 0:
        with open(os.path.join(d, "githash")) as f:
            assert f.read() == head.stdout.strip()
    else:   # not a git checkout: nothing to pin, as in the JAX package
        assert not os.path.exists(os.path.join(d, "githash"))
    tags = scalar_events(os.path.join(d, "tb"))
    assert set(tags) == jax_metric_names() | {"lr", "steps_per_sec"}
    assert all(steps == [1, 2, 3] for steps in tags.values())
    images = scalar_events(os.path.join(d, "tb_eval"))
    assert {"eval/mel_gt", "eval/mel_gen", "eval/f0"} <= set(images)
    audio = ({"eval/audio_gen", "eval/audio_gt"} <= set(images)
             or sorted(os.listdir(os.path.join(d, "tb_eval", "audio")))
             == ["eval_audio_gen_2.wav", "eval_audio_gt_2.wav"])
    assert audio
    assert os.path.exists(os.path.join(d, "ckpt_2.pt")) and os.path.exists(
        os.path.join(d, "ckpt_3.pt"))


def test_eval_without_matplotlib_still_writes_audio(run, monkeypatch, caplog):
    """The JAX trainer renders its images even for a writer that drops them,
    so where matplotlib is absent its first eval raises; the port's eval
    logs the images' absence and writes the audio."""
    from scipy.io import wavfile

    _, _, _, trainer = run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        jplotting.spectrogram_image(np.zeros((4, 4)))
    out = trainer.evaluate(7)
    assert out["n_frames"] > 0
    events = scalar_events(os.path.join(trainer.save_dir, "tb_eval"))
    wav = os.path.join(trainer.save_dir, "tb_eval", "audio", "eval_audio_gen_7.wav")
    if os.path.exists(wav):   # tensorboardX without soundfile
        sr, pcm = wavfile.read(wav)
        assert sr == 8000 and len(pcm) == out["n_frames"] * HOP
    else:
        assert 7 in events["eval/audio_gen"]
    assert 7 not in events["eval/f0"]
    assert any("no images" in r.getMessage() for r in caplog.records)


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """The same three steps with no eval, through the CLI with ``--profile
    1:2``: → (save_dir, the step-3 checkpoint)."""
    root = tmp_path_factory.mktemp("trainer_tools_cli")
    cfg_path, data_root = workspace(root)   # eval_interval 100: no eval
    cli.main(["-c", cfg_path, "--data-root", data_root, "--max-steps", "3", "--device", "cpu",
              "--profile", "1:2"])
    save_dir = root / "run"
    yield save_dir, torch.load(save_dir / "ckpt_3.pt", map_location="cpu", weights_only=False)
    shutil.rmtree(root, ignore_errors=True)


def test_evals_leave_training_bit_equal(run, plain_run):
    _, _, _, with_eval = run
    _, state = plain_run
    assert state["step"] == 3 == with_eval.global_step
    for name, model in (("model_g", with_eval.model_g), ("model_d", with_eval.model_d)):
        ours = model.state_dict()
        assert ours.keys() == state[name].keys()
        assert all(torch.equal(ours[k], state[name][k]) for k in ours)


def test_run_directory_serves(run):
    cfg, _, _, trainer = run
    engine = TTSEngine.from_checkpoint(os.path.join(cfg.train.save_dir, "config.json"),
                                       cfg.train.save_dir, device="cpu")
    assert all(torch.equal(v, trainer.model_g.state_dict()[k])
               for k, v in engine.model.state_dict().items())
    out = engine.synthesize(phones=["n", "i2", "h", "ao3"], speaker=1)
    assert out["sampling_rate"] == cfg.data.sampling_rate
    assert len(out["audio"]) > 0 and np.isfinite(out["audio"]).all()
    assert len(out["f0"]) == 4 and len(out["duration"]) == 4


def test_eval_synthesis_matches_jax_infer(tmp_path):
    """``synthesize_utterance`` (what ``evaluate`` runs) at noise scale 0
    against JAX's ``infer`` on the same weights and batch."""
    cfg_path, data_root = workspace(tmp_path)
    pcfg = load_config(cfg_path)
    jcfg = jax_config_from_dict(json.loads(open(cfg_path).read()))
    val = FilelistDataset(pcfg.data.validation_files, pcfg.data, data_root)
    jm = JaxSynthesizer.from_config(jcfg, N_SYMBOLS, policy=FLOAT32_XLA)
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
    for name, s in flatten_dict(shapes, sep="/").items():   # as tests/test_torch_synthesizer.py
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
    flat["duration_predictor/proj/bias"][:] = 1.6   # a few frames a phoneme
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_SYMBOLS), flat, 1).train()
    out = synthesize_utterance(pm, val, 0, noise_scale=0.0, seed=2)
    assert pm.training   # inference ran in eval mode and restored train mode
    raw = out["batch"]
    # the duration trap: no predicted duration within rounding of an integer
    with torch.no_grad():
        pm.eval()
        x, x_mask = pm.enc_p(torch.from_numpy(raw["phonemes"]),
                             torch.from_numpy(raw["phoneme_lengths"]))
        logw = pm.duration_predictor(x, x_mask, g=pm._speaker(torch.from_numpy(raw["sid"])))
    n = int(raw["phoneme_lengths"][0])
    w = (torch.exp(logw[0, :n, 0]) - 1.0).numpy().astype(np.float64)
    assert np.all(np.abs(w - np.round(w)) > 1e-3)
    variables = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    t_frames = raw["spec"].shape[1]
    assert t_frames == 1024
    audio, frame_mask, *_ = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(raw["phonemes"]), jnp.asarray(raw["phoneme_lengths"]), t_frames,
        sid=jnp.asarray(raw["sid"]), noise_scale=0.0, method=JaxSynthesizer.infer,
        rngs={"sample": jax.random.PRNGKey(0)}))(variables)
    n_frames = int(np.asarray(frame_mask).sum())
    assert out["n_frames"] == n_frames > 0
    want = np.asarray(audio)[0, :n_frames * HOP, 0]
    np.testing.assert_allclose(out["audio"], want, rtol=0, atol=AUDIO_ATOL)


# ------------------------------------------------------------------ CLI

def test_cli_profile_writes_a_trace(plain_run):
    save_dir, _ = plain_run
    assert os.listdir(save_dir / "profile") == ["trace_step_1.json"]
    with open(save_dir / "profile" / "trace_step_1.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_step_1" in names and any(n and n.startswith("aten::") for n in names)


@pytest.mark.parametrize("value", ["1", "a:2", "1-2", "1:"])
def test_cli_profile_malformed_fails_as_jax(value, tmp_path, monkeypatch, capsys):
    cfg_path, data_root = workspace(tmp_path)
    with pytest.raises(SystemExit) as ours:
        cli.main(["-c", cfg_path, "--data-root", data_root, "--device", "cpu",
                  "--profile", value])
    our_err = capsys.readouterr().err.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["train", "-c", cfg_path, "--profile", value])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main()
    their_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours.value.code == theirs.value.code == 2
    assert our_err.split(" error: ")[1] == their_err.split(" error: ")[1] == \
        "--profile expects START:STOP (two integers)"
    assert not os.path.exists(tmp_path / "run")


def test_config_round_trips(tmp_path):
    cfg_path, _ = workspace(tmp_path)
    cfg = load_config(cfg_path)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, spk2id=(("alice", 1), ("bob", 2))),
        train=dataclasses.replace(cfg.train, bf16_only=("dec", "flow")),
        extra=(("note", "x"),))
    from vispeech_tpu.config import config_from_dict as jax_from
    from vispeech_tpu_torch.config import save_config

    save_config(cfg, str(tmp_path / "saved.json"))
    assert load_config(str(tmp_path / "saved.json")) == cfg
    # the JAX package reads the port's config.json as the same config
    assert jax_from(cfg.to_dict()).to_dict() == cfg.to_dict()
