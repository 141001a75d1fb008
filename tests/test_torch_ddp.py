"""The trainer's data axis (``vispeech_tpu_torch/parallel``) on the CPU:
gloo process groups of 2 ranks (and of 1), spawned with
torch.multiprocessing, one thread a rank, joined by a ``file://``
rendezvous under ``tmp_path`` (no port shared with other test workers);
every join has a hard timeout, so a hung collective fails its test.

- 2 ranks on the halves of a batch take the step of 1 process on the
  whole batch (injected posterior noise and segment starts, dropout 0, the
  halves' phoneme and frame counts unequal): both grad norms, the averaged
  metrics, every gradient and every parameter after 2 steps.  Only the
  summation order differs: grad norms and metrics within 1e-5 relative,
  each gradient within 1e-5 of its parameter's largest, each network's
  parameters within 1e-6 after two AdamW steps of 2e-4 but for the
  elements whose gradient is rounding noise (the test's docstring).
- A 1-rank gloo Trainer ends bit-equal to the one-process Trainer.
- The ranks' random streams differ (F's keep masks, ``nn.Dropout``'s).
- 2 + 2 steps with a resume equal 4 steps; a stop asked on one rank stops
  both at one step with one checkpoint; only rank 0 writes.
- ``torchrun --nproc_per_node 2 ... --device cpu`` through the CLI.

The JAX package is not imported here: ``tests/test_torch_train.py`` holds
the port's one-process step and its step on 2 ranks (``job_step_on_halves``)
against JAX's.  Each checkpoint holds the full-width discriminators
(~590 MB), so the jobs delete their run dirs.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops.kernels import rel_attention_train
from vispeech_tpu_torch.parallel import Mesh, make_mesh
from vispeech_tpu_torch.parallel.mesh import RANK_SEED_STRIDE
from vispeech_tpu_torch.train.step import TrainStep
from vispeech_tpu_torch.utils.checkpoint import rank_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 120   # seconds a spawned job may take before it counts as hung
N_VOCAB = 40
TINY = {
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False,
              "learning_rate": 2e-4, "c_mel": 45, "c_kl": 1.0, "log_interval": 1,
              "eval_interval": 1000},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}
SEED = 1234


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Job:
    """``job(init_method, *args)`` started in ``world`` spawned ranks
    (RANK, WORLD_SIZE and LOCAL_RANK set as torchrun sets them);
    ``join`` fails on a rank that exits nonzero or outlives
    ``JOIN_TIMEOUT`` from the start."""

    def __init__(self, tmp_path, world, job, *args):
        ctx = mp.get_context("spawn")
        self.name, self.start = job.__name__, time.monotonic()
        init = f"file://{tmp_path}/rendezvous_{job.__name__}"
        self.procs = [ctx.Process(target=_rank_main, args=(rank, world, job, init, args))
                      for rank in range(world)]
        for p in self.procs:
            p.start()

    def join(self):
        for p in self.procs:
            p.join(max(self.start + JOIN_TIMEOUT - time.monotonic(), 0.0))
        self.kill()
        assert [p.exitcode for p in self.procs] == [0] * len(self.procs), \
            f"{self.name}: exit codes {[p.exitcode for p in self.procs]} (None: hung)"

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def _rank_main(rank, world, job, init, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    # tensorboardX imports google.cloud.storage, for gs:// logs, where it is
    # installed: seconds a process.  The jobs log to local dirs.
    sys.modules.setdefault("google.cloud.storage", None)
    job(init, *args)


def _cfg(p_dropout=0.1, **train):
    cfg = copy.deepcopy(TINY)
    cfg["model"]["p_dropout"] = p_dropout
    cfg["train"].update(train)
    return cfg


def _workspace(root):
    from vispeech_tpu_torch.data.synthetic import write_synthetic_dataset

    tr, va, data_root = write_synthetic_dataset(str(root), sr=8000, hop=8, n_utts=8,
                                                n_phones=5, dur_range=(2, 4))
    cfg = _cfg()
    cfg["data"].update(training_files=tr, validation_files=va)
    return cfg, data_root


# --- equivalence: 2 ranks on halves == 1 process on the whole batch --------

B, N, T, HOP = 4, 6, 16, 8
DUR = np.array([[2, 3, 2, 1, 2, 2], [3, 2, 2, 2, 1, 2], [2, 2, 3, 2, 0, 0],
                [3, 3, 2, 0, 0, 0]])


def _batch():
    """4 utterances: rank 0's half has 12 phonemes and 24 frames, rank 1's
    7 and 17."""
    r = np.random.RandomState(0)
    spec_lengths = DUR.sum(1)
    wav = np.clip(r.randn(B, T * HOP, 1) * 0.2, -1, 1).astype(np.float32)
    batch = dict(
        phonemes=torch.from_numpy(r.randint(1, N_VOCAB, size=(B, N))),
        phoneme_lengths=torch.tensor([6, 6, 4, 3]),
        f0=torch.from_numpy(r.uniform(80, 400, (B, N)).astype(np.float32)),
        energy=torch.from_numpy(r.uniform(30, 90, (B, N)).astype(np.float32)),
        duration=torch.from_numpy(DUR), spec=None,
        spec_lengths=torch.from_numpy(spec_lengths), wav=torch.from_numpy(wav),
        sid=torch.tensor([0, 2, 1, 3]))
    eps = torch.from_numpy(r.randn(B, T, TINY["model"]["inter_channels"]).astype(np.float32))
    return batch, eps, torch.tensor([2, 4, 1, 0])


def _models(cfg):
    """In eval mode: no dropout anywhere (the variance heads' rate is fixed
    at 0.5), gradients still on."""
    g = random_init_(Synthesizer.from_config(cfg, N_VOCAB), SEED).eval()
    d = random_init_(MultiPeriodDiscriminator(), SEED + 1).eval()
    return g, d


def _grads(g, d):
    return {**{"g." + k: None if p.grad is None else p.grad.clone()
               for k, p in g.named_parameters()},
            **{"d." + k: None if p.grad is None else p.grad.clone()
               for k, p in d.named_parameters()}}


def _steps(mesh, rows):
    """2 steps on the batch rows ``rows`` → {"metrics" of each step averaged
    over the ranks, "grads" of each step, "params" after both}, and the
    step."""
    cfg = config_from_dict(_cfg(p_dropout=0.0))
    g, d = _models(cfg)
    step = TrainStep(cfg, g, d, steps_per_epoch=10, mesh=mesh)
    batch, eps, ids = _batch()
    part = {k: None if v is None else v[rows] for k, v in batch.items()}
    out = {"metrics": [], "grads": []}
    for _ in range(2):
        m = step(part, eps_q=eps[rows], ids_slice=ids[rows])
        out["metrics"].append({k: float(v) for k, v in mesh.mean_metrics(m).items()})
        out["grads"].append(_grads(g, d))
    out["params"] = {**{"g." + k: v for k, v in g.state_dict().items()},
                     **{"d." + k: v for k, v in d.state_dict().items()}}
    return out, step


def _job_halves(init, out_dir):
    mesh = make_mesh(device="cpu", init_method=init)
    try:
        out, step = _steps(mesh, slice(2 * mesh.rank, 2 * mesh.rank + 2))
        # this rank's first attention dropout seed and nn.Dropout draws
        seeds = torch.Generator().manual_seed(0)
        seeds.set_state(step.seed_generator.get_state())
        keep = rel_attention_train.dropout_keep(
            rel_attention_train.draw_seed(seeds), 0.1, 2, 2, 16)
        torch.manual_seed(mesh.seed(SEED))
        drop = torch.nn.functional.dropout(torch.ones(64), 0.5)
        torch.save({**out, "keep": keep, "drop": drop},
                   os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


def job_step_on_halves(init, out_dir, cfg_dict, n_vocab, flat_g, flat_d, batch, eps, ids):
    """One step at learning rate 0 of the flax weights ``flat_g`` and
    ``flat_d`` (the scale discriminator and period 2), rank r on row r of
    ``batch``: → ``rank{r}.pt`` with the ranks' mean metrics and the
    averaged gradients.  ``tests/test_torch_train.py`` holds it against
    JAX's step on the whole batch."""
    from vispeech_tpu_torch.utils.jax_weights import load_flax_params

    mesh = make_mesh(device="cpu", init_method=init)
    try:
        c = copy.deepcopy(cfg_dict)
        c["train"]["learning_rate"] = 0.0
        cfg = config_from_dict(c)
        g = load_flax_params(Synthesizer.from_config(cfg, n_vocab), flat_g, 1).eval()
        d = load_flax_params(MultiPeriodDiscriminator(periods=(2,)), flat_d,
                             discriminator=True).eval()
        step = TrainStep(cfg, g, d, steps_per_epoch=10, mesh=mesh)
        row = slice(mesh.rank, mesh.rank + 1)
        m = step({k: v[row] for k, v in batch.items()}, eps_q=eps[row], ids_slice=ids[row])
        torch.save({"metrics": {k: float(v) for k, v in mesh.mean_metrics(m).items()},
                    "g": {k: p.grad for k, p in g.named_parameters()},
                    "d": {k: p.grad for k, p in d.named_parameters()}},
                   os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The 1-rank job and the torchrun CLI, started first: they run beside
    the 2-rank jobs."""
    tmp = tmp_path_factory.mktemp("background")
    cfg, data_root = _workspace(tmp / "one")
    world_one = Job(tmp, 1, _job_world_one, cfg, data_root, str(tmp / "one"))
    cfg, data_root = _workspace(tmp / "cli")
    cfg["train"]["save_dir"] = str(tmp / "cli" / "run")
    (tmp / "cli" / "config.json").write_text(json.dumps(cfg))
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "vispeech_tpu_torch.train.cli", "-c", str(tmp / "cli" / "config.json"),
         "--data-root", data_root, "--max-steps", "1", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield {"tmp": tmp, "world_one": world_one, "cli": cli}
    world_one.kill()
    if cli.poll() is None:
        cli.kill()
        cli.communicate()


@pytest.fixture(scope="module")
def halves(tmp_path_factory, background):
    tmp = tmp_path_factory.mktemp("halves")
    job = Job(tmp, 2, _job_halves, str(tmp))
    want, _ = _steps(Mesh(), slice(0, B))
    job.join()
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return got, want


def test_two_ranks_on_halves_equal_one_process_on_the_batch(halves):
    """Summation order is all that differs.  Metrics and grad norms within
    1e-5 relative.  Gradients: each within 1e-5 of its parameter's largest
    at step 1 and 1e-4 at step 2 (floored at 1e-3 of the network's largest
    gradient), since after step 1 AdamW has moved the parameters whose
    gradient is rounding noise by up to the rate, differently in the two
    runs.  Parameters after 2 steps of rate 2e-4, held per network: the
    attention key biases (their gradient is 0 in exact arithmetic: softmax
    is shift-invariant, so AdamW moves them by rounding noise's sign) each
    element to 2 · 2e-4; every other tensor all but max(1, 1e-5 of its
    elements) to 1e-6, the network all but 1e-5 of its other elements, and
    each element to 2 · 2e-4 (an element whose gradient is rounding noise
    moves by up to the rate a step)."""
    got, want = halves
    for a, b in zip(got[0]["metrics"], want["metrics"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert got[0]["metrics"] == got[1]["metrics"]   # every rank logs the same
    for step, rel in ((0, 1e-5), (1, 1e-4)):
        want_g, got_g = want["grads"][step], got[0]["grads"][step]
        biggest = max(float(g.abs().max()) for g in want_g.values() if g is not None)
        for k, w in want_g.items():
            a = got_g[k]
            if w is None:
                assert a is None, k
                continue
            tol = rel * max(float(w.abs().max()), 1e-3 * biggest)
            assert float((a - w).abs().max()) <= tol, (step, k)
            assert torch.equal(a, got[1]["grads"][step][k]), k   # one all-reduce result
    for net in ("g.", "d."):
        off = total = 0
        for k, w in want["params"].items():
            if not k.startswith(net):
                continue
            diff = (got[0]["params"][k] - w).abs()
            assert torch.equal(got[0]["params"][k], got[1]["params"][k]), k
            assert float(diff.max()) <= 2 * 2e-4, k
            if ".conv_k.bias" in k:
                continue
            n_off = int((diff > 1e-6).sum())
            assert n_off <= max(1, 1e-5 * w.numel()), (k, n_off)
            off, total = off + n_off, total + w.numel()
        assert off <= 1e-5 * total, (net, off, total)


def test_ranks_draw_distinct_streams(halves):
    got, _ = halves
    assert not torch.equal(got[0]["keep"], got[1]["keep"])
    assert not torch.equal(got[0]["drop"], got[1]["drop"])
    assert Mesh(rank=1).seed(SEED) == SEED + RANK_SEED_STRIDE and Mesh().seed(SEED) == SEED


# --- the Trainer on 2 ranks: resume, stop agreement, rank 0 only -----------

WRITERS = ("save_config", "check_git_hash", "TrainLogger")


def _spy_writes(calls):
    """Record every write of the run directory the Trainer makes."""
    from vispeech_tpu_torch.train import loop
    from vispeech_tpu_torch.utils.checkpoint import AsyncCheckpointer

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in WRITERS:
        setattr(loop, name, spy(name, getattr(loop, name)))
    AsyncCheckpointer.save = spy("checkpoint", AsyncCheckpointer.save)
    for name in ("evaluate", "_write_stats", "_start_profile"):
        setattr(loop.Trainer, name, spy(name, getattr(loop.Trainer, name)))
    get_logger = loop.get_logger
    loop.get_logger = lambda d=None: (calls.append("train.log") if d else None, get_logger(d))[1]


def _job_trainer(init, cfg_dict, data_root, out):
    from vispeech_tpu_torch.config import config_from_dict as load
    from vispeech_tpu_torch.train.loop import Trainer

    mesh = make_mesh(device="cpu", init_method=init)
    calls = []
    _spy_writes(calls)
    try:
        def trainer(run, **train):
            c = json.loads(json.dumps(cfg_dict))
            c["train"].update(save_dir=os.path.join(out, run), **train)
            return Trainer(load(c), data_root=data_root, mesh=mesh)

        # b: 4 straight steps; a: b's checkpoint at step 2, resumed to 4
        b = trainer("b")
        b.resume()
        b.train(max_steps=2, profile_steps=(0, 1))
        if mesh.is_main:
            os.makedirs(os.path.join(out, "a"))
            shutil.copy(os.path.join(out, "b", "ckpt_2.pt"), os.path.join(out, "a"))
        mesh.barrier()
        b.train(max_steps=4)
        a = trainer("a")
        resumed = a.resume()
        a.train(max_steps=4)
        same = all(torch.equal(x, y) for m in ("model_g", "model_d")
                   for x, y in zip(getattr(a, m).state_dict().values(),
                                   getattr(b, m).state_dict().values()))
        mesh.barrier()   # both ranks compared before rank 0 deletes
        if mesh.is_main:
            listing = {r: sorted(os.listdir(os.path.join(out, r))) for r in "ab"}
            for r in "ab":
                shutil.rmtree(os.path.join(out, r))
        # a stop asked on rank 1 alone, after its first step; an eval a step
        s = trainer("stop", eval_interval=1)
        if mesh.rank == 1:
            step = s.step_fn._step

            def stop_after(*args):
                metrics = step(*args)
                s.request_stop()
                return metrics
            s.step_fn._step = stop_after
        s.train(max_steps=4)
        stopped = mesh.gather(s.global_step)
        if mesh.is_main:
            listing["stop"] = sorted(os.listdir(os.path.join(out, "stop")))
            shutil.rmtree(os.path.join(out, "stop"))
        result = {"resumed": resumed, "same": same, "stopped": stopped, "calls": calls,
                  "steps": (a.global_step, b.global_step)}
        if mesh.is_main:
            result["listing"] = listing
        with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    cfg, data_root = _workspace(tmp)
    out = tmp / "out"
    out.mkdir()
    Job(tmp, 2, _job_trainer, cfg, data_root, str(out)).join()
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_resume_on_two_ranks_equals_straight_steps(trainer_runs):
    for r in trainer_runs:
        assert r["resumed"] == 2 and r["steps"] == [4, 4] and r["same"]
    listing = trainer_runs[0]["listing"]
    assert "ckpt_4.pt" in listing["a"] and "ckpt_4.pt" in listing["b"]


def test_a_stop_on_one_rank_stops_both_at_one_step(trainer_runs):
    assert [r["stopped"] for r in trainer_runs] == [[1, 1]] * 2
    assert [f for f in trainer_runs[0]["listing"]["stop"] if f.startswith("ckpt_")] \
        == ["ckpt_1.pt"]


def test_only_rank_zero_writes_the_run_directory(trainer_runs):
    main, other = trainer_runs[0]["calls"], trainer_runs[1]["calls"]
    assert other == []
    for name in (*WRITERS, "train.log", "checkpoint", "evaluate", "_write_stats",
                 "_start_profile"):
        assert name in main, name
    listing = trainer_runs[0]["listing"]["b"]
    for name in ("config.json", "tb", "tb_eval", "train.log", "train_stats.json",
                 "profile"):
        assert name in listing, name


# --- world size 1, and the checkpoint's per-rank random states -------------

def _job_world_one(init, cfg_dict, data_root, out):
    from vispeech_tpu_torch.config import config_from_dict as load
    from vispeech_tpu_torch.train.loop import Trainer

    def run(name, mesh):
        c = json.loads(json.dumps(cfg_dict))
        c["train"]["save_dir"] = os.path.join(out, name)
        t = Trainer(load(c), data_root=data_root, device="cpu", mesh=mesh)
        t.train(max_steps=2)
        state = {k: v for k, v in t.state_dict().items() if k in ("model_g", "model_d")}
        state["optim"] = [t.step_fn.opt_g.state_dict()["state"],
                          t.step_fn.opt_d.state_dict()["state"]]
        shutil.rmtree(c["train"]["save_dir"])
        return state

    plain = run("plain", None)
    mesh = make_mesh(device="cpu", init_method=init)
    try:
        assert mesh.world_size == 1 and mesh.group is not None
        dist = run("dist", mesh)
    finally:
        mesh.close()

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return a == b

    with open(os.path.join(out, "world_one.json"), "w") as f:
        json.dump({"equal": equal(plain, dist)}, f)


def test_one_rank_is_bit_equal_to_one_process(background):
    background["world_one"].join()
    assert json.loads((background["tmp"] / "one" / "world_one.json").read_text())["equal"]


def test_checkpoint_random_states_by_rank():
    one = {"generator": 1, "seed_generator": 2, "torch_rng": 3, "cuda_rng": None}
    assert rank_rng(one, 0) == one and rank_rng(one, 1) is None
    two = {**one, "rank_rng": [one, {**one, "generator": 5}]}
    assert rank_rng(two, 1)["generator"] == 5 and rank_rng(two, 2) is None


# --- the mesh's refusals, and the CLI under torchrun ------------------------

def test_mesh_without_a_launcher_is_a_world_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    with pytest.raises(ValueError, match="launcher"):
        make_mesh(data=2, device="cpu")


def test_mesh_refuses_what_it_cannot_run(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="launcher"):   # model > 1 in one process
        make_mesh(model=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not divide the world size 2"):
        make_mesh(model=3, device="cpu")
    with pytest.raises(ValueError, match="data=2"):
        make_mesh(data=2, model=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make_mesh()
    # CUDA without NCCL raises before touching the card; it never runs gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)

    def no_card(*_):
        raise AssertionError("touched the card")
    monkeypatch.setattr(torch.cuda, "set_device", no_card)
    monkeypatch.setattr(dist, "init_process_group", no_card)
    with pytest.raises(RuntimeError, match="NCCL"):
        make_mesh(device="cuda")


def test_cli_runs_under_torchrun_on_two_ranks(background):
    cli, run = background["cli"], background["tmp"] / "cli" / "run"
    try:
        _, err = cli.communicate(timeout=JOIN_TIMEOUT)
        assert cli.returncode == 0, err[-3000:]
        listing = os.listdir(run)
        for name in ("ckpt_1.pt", "config.json", "train.log", "tb"):
            assert name in listing, (name, listing)
        assert "rank 1 of 2" in err
    finally:
        shutil.rmtree(run, ignore_errors=True)
