"""The trainer's model axis (tensor parallelism, ``vispeech_tpu_torch/
parallel``) on the CPU: gloo groups of spawned ranks, one thread each, at
``torch_tp_jobs.TP_TINY`` (``test_torch_ddp.py``'s tiny model with a
decoder of 128 channels and a WaveNet of 32, so that the model axis shards
at 2).

- The port's sharded keys and dims equal JAX's ``param_shardings`` on the
  same tree (``tests/test_sharding.py``'s config, ``TP_TINY`` and
  ``configs/config.json``), mapped through the weight bridge; a renamed
  module raises under ``require_match``.
- Each sharded layer on 2 ranks against the whole layer in f64: output,
  input gradient, every parameter gradient within 1e-10.
- (data 1 × model 2) and (data 2 × model 2, unequal halves) against one
  process on the whole batch over 2 steps, at ``test_torch_ddp.py``'s
  bounds; a model group's ranks draw the same F keep masks and
  ``nn.Dropout`` masks, data ranks distinct ones.
- Checkpoints: 2 steps on the model axis resumed for 2 in one process
  equal 4 steps in one process; a one-process checkpoint resumes on the
  model axis (each rank its slices and data rank 0's streams); the model
  axis's checkpoint serves; a JAX checkpoint loads into a sharded
  generator; the model group's eval equals one process's.
- ``torchrun --nproc_per_node 2 ... --model-parallel 2 --device cpu``.

The spawned ranks live in ``torch_tp_jobs.py`` (no JAX there).  The
Trainers here run with the scale discriminator and one period (the model
axis leaves the discriminators replicated): smaller checkpoints.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_ddp import JOIN_TIMEOUT, ROOT, Job
from torch_tp_jobs import (
    B,
    N_VOCAB,
    TP_TINY,
    job_model_pair,
    job_one_process,
    job_two_by_two,
    layer_grads,
    steps,
    tp_cfg,
)
from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.models import MultiPeriodDiscriminator as JaxMPD
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.parallel import make_mesh as jax_make_mesh
from vispeech_tpu.parallel import param_shardings
from vispeech_tpu.train.step import TrainState, make_optimizer as jax_make_optimizer
from vispeech_tpu.utils.checkpoint import _path_str
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.parallel import Mesh, ModelShard
from vispeech_tpu_torch.parallel.sharding import shard_model_, shard_rule
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.train.step import make_optimizer
from vispeech_tpu_torch.utils.jax_weights import load_jax_checkpoint, port_key, port_tensor

LR = TP_TINY["train"]["learning_rate"]
# tests/test_sharding.py's configuration
SHARDING_CFG = {
    "train": {"segment_size": 256},
    "data": {"sampling_rate": 8000, "filter_length": 128, "hop_length": 64,
             "win_length": 128, "n_speakers": 2},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1,
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [8, 4, 2], "upsample_initial_channel": 128,
              "upsample_kernel_sizes": [16, 8, 4], "gin_channels": 8},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(which):
    if which == "config.json":
        with open(os.path.join(ROOT, "configs", "config.json")) as f:
            return json.load(f)
    return SHARDING_CFG if which == "test_sharding" else TP_TINY


@functools.lru_cache(maxsize=None)
def _jax_params_shape(which):
    """The JAX generator's parameter shapes (``eval_shape`` of its training
    init: every module, the posterior encoder too) at config ``which``."""
    jcfg = jax_config_from_dict(_config(which))
    d = jcfg.data
    n, t = 8, jcfg.train.segment_size // d.hop_length + 4
    i32 = jnp.int32
    args = (jnp.ones((1, n), i32), jnp.full((1,), n, i32), jnp.full((1, n), 200.0),
            jnp.full((1, n), 60.0), jnp.full((1, n), 2, i32),
            jnp.zeros((1, t, d.filter_length // 2 + 1)), jnp.full((1,), t, i32),
            jnp.zeros((1,), i32))
    jm = JaxSynthesizer.from_config(jcfg, N_VOCAB)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sample", "dropout"))}
    return jcfg, jax.eval_shape(lambda: jm.init(rngs, *args, deterministic=True))["params"]


@pytest.mark.parametrize("which", ["test_sharding", "TP_TINY", "config.json"])
def test_sharded_keys_equal_jax_param_shardings(jobs, which):
    """JAX's 'model' leaves on an 8-device (data 4 × model 2) mesh, mapped
    through ``utils/jax_weights.py``, are the port's sharded parameters,
    each on the dim that holds JAX's last (output-channel) dim.  (It asks
    for ``jobs`` so that the spawned ranks run beside its traces.)"""
    cfg = _config(which)
    jcfg, shapes = _jax_params_shape(which)
    specs = param_shardings(shapes, jax_make_mesh(data=4, model=2), require_match=True)
    n_kernels = len(jcfg.model.resblock_kernel_sizes)
    want = set()
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sharding.spec)
        if spec and spec[-1] == "model":
            keys = tuple(_path_str(path).split("/"))
            ndim = len(spec)
            probe = port_tensor(keys, np.zeros((1,) * (ndim - 1) + (2,)))
            want.add((port_key(keys, n_kernels), probe.shape.index(2)))
    model = Synthesizer.from_config(config_from_dict(cfg), N_VOCAB)
    got = {(k, shard_rule(k, p.shape, 2)[0]) for k, p in model.named_parameters()
           if shard_rule(k, p.shape, 2) is not None}
    assert want and got == want


def test_require_match_raises_on_a_renamed_module():
    g = Synthesizer.from_config(config_from_dict(TP_TINY), N_VOCAB)
    renamed = nn.Module()
    renamed.vocoder = g.dec
    shard = ModelShard(None, 0, 2)
    with pytest.raises(ValueError, match="renamed"):
        shard_model_(renamed, shard, require_match=True)
    assert shard_model_(renamed, shard).dims == {}
    plan = shard_model_(g, shard, require_match=True)
    assert plan.dims["dec.ups.0.weight_v"] == 1 and "dec.ups.1.weight_v" not in plan.dims
    assert g.dec.ups[0].weight_v.shape == (128, 32, 8)
    assert set(plan.partial) >= {"dec.conv_pre.bias", "dec.ups.0.weight_g", "dec.ups.0.bias"}
    assert not any(k.startswith(("enc_q", "flow")) for k in plan.partial)


# --- a JAX checkpoint into a sharded generator -----------------------------

def test_jax_checkpoint_loads_into_the_model_axis(tmp_path):
    """Model rank 1's slices of every sharded parameter and its AdamW
    moments, from a JAX ``ckpt_*.npz`` (random arrays at the paths
    ``flatten_state`` writes), equal the whole load's."""
    jcfg, shapes = _jax_params_shape("TP_TINY")
    d_shapes = jax.eval_shape(lambda: JaxMPD(periods=()).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 1)), jnp.zeros((1, 64, 1))))["params"]
    tx = jax_make_optimizer(jcfg, 10)
    state = TrainState(step=jnp.int32(5), params_g={"params": shapes},
                       params_d={"params": d_shapes},
                       opt_state_g=jax.eval_shape(tx.init, shapes),
                       opt_state_d=jax.eval_shape(tx.init, d_shapes),
                       rng=jnp.zeros((2,), jnp.uint32))
    r = np.random.default_rng(6)
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        shape, dtype = np.shape(leaf), np.dtype(leaf.dtype)
        flat[_path_str(kp)] = (np.asarray(leaf) if not isinstance(leaf, jax.ShapeDtypeStruct)
                               else (np.full(shape, 3, dtype) if dtype.kind in "iu"
                                     else r.standard_normal(shape, np.float32)))
    np.savez(tmp_path / "ckpt_5.npz", **flat)
    cfg = config_from_dict(TP_TINY)

    def load(shard):
        g = Synthesizer.from_config(cfg, N_VOCAB)
        plan = shard_model_(g, shard, require_match=True) if shard else None
        d = MultiPeriodDiscriminator(())
        opt_g, opt_d = make_optimizer(cfg, g), make_optimizer(cfg, d)
        assert load_jax_checkpoint(str(tmp_path), g, d, opt_g, opt_d, 1, plan) == 5
        return g, opt_g, plan

    whole, opt_whole, _ = load(None)
    g, opt_g, plan = load(ModelShard(None, 1, 2))
    params = dict(g.named_parameters())
    assert len(plan.dims) > 10
    for k, w in whole.named_parameters():
        assert torch.equal(params[k], plan.own(k, w.detach())), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_g.state[params[k]][m], plan.own(k, opt_whole.state[w][m])), k


# --- the spawned jobs --------------------------------------------------------

def _workspace(root):
    from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset

    tr, va, data_root = write_synthetic_dataset(str(root), sr=8000, hop=8, n_utts=8,
                                                n_phones=5, dur_range=(2, 4))
    cfg = tp_cfg()
    cfg["data"].update(training_files=tr, validation_files=va)
    return cfg, data_root


def _state(path):
    s = torch.load(path, weights_only=False)
    return {"model_g": s["model_g"], "model_d": s["model_d"],
            "moments_g": s["optim_g"]["state"], "moments_d": s["optim_d"]["state"]}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The spawned ranks, the one-process references (a process of their
    own) and the torchrun CLI, started by the first test, which runs the
    JAX traces beside them."""
    tmp = tmp_path_factory.mktemp("tp")
    cfg, data_root = _workspace(tmp / "data")
    (tmp / "cli").mkdir()
    cli_cfg = json.loads(json.dumps(cfg))
    cli_cfg["train"]["save_dir"] = str(tmp / "cli" / "run")
    (tmp / "cli" / "config.json").write_text(json.dumps(cli_cfg))
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "vispeech_tpu_torch.train.cli", "-c", str(tmp / "cli" / "config.json"),
         "--data-root", data_root, "--max-steps", "1", "--device", "cpu",
         "--model-parallel", "2"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = tmp / "out"
    out.mkdir()
    started = {}
    try:
        started["pair"] = Job(tmp, 2, job_model_pair, str(out), cfg, data_root)
        started["quad"] = Job(tmp, 4, job_two_by_two, str(out))
        started["one"] = Job(tmp, 1, job_one_process, str(out), cfg, data_root)
        yield {"tmp": tmp, "out": out, "cfg": cfg, "data_root": data_root, "cli": cli,
               **started}
    finally:
        for job in started.values():
            job.kill()
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def runs(jobs):
    for name in ("pair", "quad", "one"):
        jobs[name].join()
    out = jobs["out"]
    return {**jobs, "want_step": torch.load(out / "refs_step.pt", weights_only=False),
            "want_layers": torch.load(out / "refs_layers.pt", weights_only=False),
            "back_at": torch.load(out / "back_at.pt")["back_at"],
            "pair": [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)],
            "quad": [torch.load(out / f"quad{r}.pt", weights_only=False) for r in range(4)]}


def _job_steps(runs, name):
    """The ``steps`` of each rank of ``job_two_by_two``: ``name`` "2x2" or
    "1x2" (each model group alone)."""
    return [r[name] for r in runs["quad"]]


@pytest.mark.parametrize("layer", ["Conv1d", "WNConv1d", "WNConv1d, weight gathered",
                                   "WNConvTranspose1d", "ResBlock1"])
def test_sharded_layer_equals_the_whole_layer(runs, layer):
    """f64: the output, the input gradient (summed over the model group by
    ``copy``'s backward) and every parameter gradient (gathered; the whole
    gains' and biases' summed) within 1e-10; the transposed conv's weight
    norm sums its squares over both ranks."""
    want_y, want_dx, want_grads, _ = runs["want_layers"][layer]
    for rank in runs["pair"]:
        y, dx, grads, sharded = rank["layers"][layer]
        assert sharded, layer
        assert float((y - want_y).abs().max()) <= 1e-10
        assert float((dx - want_dx).abs().max()) <= 1e-10
        assert grads.keys() == want_grads.keys()
        for k, g in grads.items():
            assert float((g - want_grads[k]).abs().max()) <= 1e-10, k


def _hold_steps(got, want):
    """``test_torch_ddp.py``'s bounds: metrics and grad norms within 1e-5
    relative; each gradient within 1e-5 of its parameter's largest at step
    1 and 1e-4 at step 2 (floored at 1e-3 of the networks' largest), as
    AdamW moves the parameters whose gradient is rounding noise by up to
    the rate after step 1; parameters after 2 steps of 2e-4: each element
    within 2 · 2e-4 but the attention key biases', every tensor but those
    all but max(1, 1e-5 of its elements) within 1e-6, each network all but
    1e-5 of its elements.  The key biases' gradient is 0 in exact
    arithmetic (softmax is shift-invariant), so AdamW moves each element
    by the sign of rounding noise, either way in either run: by up to the
    rate at step 1 and 1.0056 × the rate at step 2 (the largest |m̂/√v̂|
    after two steps at β = (0.8, 0.99)), so the runs differ by up to
    2 × 2.0056 < 4.02 × the rate."""
    for a, b in zip(got["metrics"], want["metrics"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for step, rel in ((0, 1e-5), (1, 1e-4)):
        want_g, got_g = want["grads"][step], got["grads"][step]
        biggest = max(float(g.abs().max()) for g in want_g.values() if g is not None)
        for k, w in want_g.items():
            if w is None:
                assert got_g[k] is None, k
                continue
            tol = rel * max(float(w.abs().max()), 1e-3 * biggest)
            assert float((got_g[k] - w).abs().max()) <= tol, (step, k)
    for net in ("g.", "d."):
        off = total = 0
        for k, w in want["params"].items():
            if not k.startswith(net):
                continue
            diff = (got["params"][k] - w).abs()
            if ".conv_k.bias" in k:
                assert float(diff.max()) <= 4.02 * LR, k
                continue
            assert float(diff.max()) <= 2 * LR, k
            n_off = int((diff > 1e-6).sum())
            assert n_off <= max(1, 1e-5 * w.numel()), (k, n_off)
            off, total = off + n_off, total + w.numel()
        assert off <= 1e-5 * total, (net, off, total)


def test_model_pair_step_equals_one_process(runs):
    """(data 1 × model 2), both ranks on the whole batch: each model group
    of ``job_two_by_two`` alone."""
    got = _job_steps(runs, "1x2")
    assert "dec.ups.0.weight_v" in got[0]["sharded"]
    assert "flow.flows.0.enc.in_layers.0.weight_v" in got[0]["sharded"]
    _hold_steps(got[0], runs["want_step"])
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
        for k, p in got[0]["params"].items():
            assert torch.equal(p, r["params"][k]), k


def test_two_by_two_step_on_halves_equals_one_process(runs):
    """(data 2 × model 2), data rank d on rows 2d and 2d + 1, whose phoneme
    and frame counts differ."""
    assert [(r["data_rank"], r["model_rank"]) for r in runs["quad"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    got = _job_steps(runs, "2x2")
    _hold_steps(got[0], runs["want_step"])
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
        for k, p in got[0]["params"].items():
            assert torch.equal(p, r["params"][k]), k


def test_model_group_draws_one_stream_and_data_ranks_distinct_ones(runs):
    pair, quad = _job_steps(runs, "1x2"), _job_steps(runs, "2x2")
    for a, b in ((pair[0], pair[1]), (quad[0], quad[1]), (quad[2], quad[3])):
        assert torch.equal(a["keep"], b["keep"]) and torch.equal(a["drop"], b["drop"])
    assert not torch.equal(quad[0]["keep"], quad[2]["keep"])
    assert not torch.equal(quad[0]["drop"], quad[2]["drop"])
    assert torch.equal(pair[0]["keep"], quad[0]["keep"])   # data rank 0 as one process


def test_model_group_keeps_its_replicas_equal(runs):
    """Gradients of 1 + rank on ranks (data, model) = (0, 0), (0, 1), (1, 0),
    (1, 1): a replicated one is averaged over the model group, then the
    data axis (2.5 on every rank, whatever each rank computed); a partial
    one summed over the model group, then averaged (5); a slice averaged
    over the data axis alone (2 + model rank).  ``check_replicas`` passes
    on equal replicas and raises on every rank when one element of one
    rank's copy is one ulp apart."""
    for r in runs["quad"]:
        (replicated, sliced, partial), raised = r["replicas"]
        assert replicated.tolist() == [2.5] * 3
        assert partial.tolist() == [5.0] * 3
        assert sliced.tolist() == [2.0 + r["model_rank"]] * 3
        assert raised == [False, True]


def _hold_states(got, want):
    """Two runs of 4 steps at rate 2e-4 (Trainer: dropout on, the same
    streams), ``_hold_steps``' bounds carried to 4 steps.  Each element
    within 8.1 × the rate: AdamW moves an element whose gradient is
    rounding noise by up to 1, 1.0056, 1.0148 and 1.0274 × the rate at
    steps 1-4, either way in either run.  Every tensor but the attention
    key biases all but max(1, 1e-5 of its elements) within 1e-6, each
    network all but 1e-5 of those elements; each AdamW moment of those
    tensors within 1e-5 of the tensor's largest (the key biases' moments
    are of rounding noise)."""
    names = [k for k, _ in Synthesizer.from_config(config_from_dict(TP_TINY),
                                                   N_SYMBOLS).named_parameters()]
    for net in ("model_g", "model_d"):
        off = total = 0
        assert got[net].keys() == want[net].keys()
        for k, w in want[net].items():
            diff = (got[net][k] - w).abs()
            assert float(diff.max()) <= 8.1 * LR, (net, k)
            if ".conv_k.bias" in k:
                continue
            n_off = int((diff > 1e-6).sum())
            assert n_off <= max(1, 1e-5 * w.numel()), (net, k, n_off)
            off, total = off + n_off, total + w.numel()
        assert off <= 1e-5 * total, (net, off, total)
    for net in ("moments_g", "moments_d"):
        assert got[net].keys() == want[net].keys()
        for i, w in want[net].items():
            if net == "moments_g" and ".conv_k.bias" in names[i]:
                continue
            for k in ("exp_avg", "exp_avg_sq"):
                tol = 1e-5 * float(w[k].abs().max())
                assert float((got[net][i][k] - w[k]).abs().max()) <= tol, (net, i, k)


def test_model_axis_checkpoint_resumes_in_one_process(runs):
    """Whole tensors on disk: 2 steps on the model axis + 2 in one process
    equal 4 in one process."""
    out = runs["out"]
    saved = torch.load(out / "tp" / "ckpt_2.pt", weights_only=False)
    assert saved["model_parallel"] == 2 and len(saved["rank_rng"]) == 2
    assert saved["model_g"]["dec.ups.0.weight_v"].shape == (128, 64, 8)
    assert runs["back_at"] == 2
    _hold_states(_state(out / "back" / "ckpt_4.pt"), _state(out / "one" / "ckpt_4.pt"))


def test_one_process_checkpoint_resumes_on_the_model_axis(runs):
    """Each rank takes its slices of the one-process step-2 checkpoint and
    the random streams of data rank 0: gathered whole again, its state is
    the file's, bit for bit."""
    saved = torch.load(runs["out"] / "one" / "ckpt_2.pt", weights_only=False)
    assert "rank_rng" in saved and len(saved["rank_rng"]) == 1
    for rank in runs["pair"]:
        assert rank["resumed_at"] == 2
        for net in ("model_g", "model_d"):
            got = rank["resumed"][net]
            assert got.keys() == saved[net].keys()
            assert all(torch.equal(v, saved[net][k]) for k, v in got.items()), net
        for net in ("optim_g", "optim_d"):
            got, want = rank["resumed"][net]["state"], saved[net]["state"]
            assert got.keys() == want.keys()
            for i, st in want.items():
                for k, v in st.items():
                    assert torch.equal(got[i][k], v), (net, i, k)
        for k in ("generator", "seed_generator", "torch_rng"):
            assert torch.equal(rank["resumed_rng"][k], saved["rank_rng"][0][k]), k


def test_model_axis_checkpoint_serves(runs):
    from vispeech_tpu_torch.infer.pipeline import TTSEngine

    run = runs["out"] / "tp"
    engine = TTSEngine.from_checkpoint(str(run / "config.json"), str(run), step=2,
                                       device="cpu")
    saved = torch.load(run / "ckpt_2.pt", weights_only=False)["model_g"]
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    audio = engine.synthesize(text="[P]ni2 hao3[P]", noise_scale=0.5, seed=3)["audio"]
    assert audio.size and np.isfinite(audio).all()


def test_model_group_eval_equals_one_process_eval(runs):
    """The eval at step 2 of data rank 0's model group (both ranks run it;
    the decoder's convs gather over them) against one process on the same
    weights, within 1e-5 of the audio's peak."""
    from vispeech_tpu_torch.data.dataset import FilelistDataset
    from vispeech_tpu_torch.train.loop import synthesize_utterance

    cfg = config_from_dict(runs["cfg"])
    model = Synthesizer.from_config(cfg, N_SYMBOLS)
    model.load_state_dict(torch.load(runs["out"] / "tp" / "ckpt_2.pt",
                                     weights_only=False)["model_g"])
    val = FilelistDataset(cfg.data.validation_files, cfg.data, runs["data_root"])
    want = synthesize_utterance(model, val, 0, 1024, seed=2)["audio"]
    got = [r["eval"] for r in runs["pair"]]
    assert got[0].shape == want.shape and np.array_equal(got[0], got[1])
    assert np.abs(got[0] - want).max() <= 1e-5 * np.abs(want).max()


def test_cli_trains_on_the_model_axis_under_torchrun(runs):
    cli, run = runs["cli"], runs["tmp"] / "cli" / "run"
    _, err = cli.communicate(timeout=JOIN_TIMEOUT)
    assert cli.returncode == 0, err[-3000:]
    assert "ckpt_1.pt" in os.listdir(run)
    assert "rank 1 of 2 (model axis 2)" in err
