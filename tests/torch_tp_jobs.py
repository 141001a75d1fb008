"""The spawned ranks of ``tests/test_torch_tp.py`` (the model axis on the
CPU, gloo).  A module of its own, which imports no JAX: each spawned rank
imports it afresh.  ``test_torch_ddp.Job`` starts them."""

import copy
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops.kernels import rel_attention_train
from vispeech_tpu_torch.ops.layers import Conv1d, WNConv1d, WNConvTranspose1d
from vispeech_tpu_torch.ops.resblock import ResBlock1
from vispeech_tpu_torch.parallel import Mesh, make_mesh
from vispeech_tpu_torch.parallel.mesh import all_reduce_mean_
from vispeech_tpu_torch.parallel.sharding import shard_model_
from vispeech_tpu_torch.train.step import TrainStep

N_VOCAB = 40
SEED = 1234
PERIODS = (2,)   # the scale discriminator and one period: D is replicated
# test_torch_ddp.py's TINY, wide enough that the model axis shards at 2:
# conv_pre (128), ups.0 and stage 0's ResBlock (64), and the WaveNet input
# convs (2 · hidden = 64)
TP_TINY = {
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False,
              "learning_rate": 2e-4, "c_mel": 45, "c_kl": 1.0, "log_interval": 1,
              "eval_interval": 1000},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 32, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 128,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}

B, N, T, HOP = 4, 6, 16, 8
DUR = np.array([[2, 3, 2, 1, 2, 2], [3, 2, 2, 2, 1, 2], [2, 2, 3, 2, 0, 0],
                [3, 3, 2, 0, 0, 0]])


def tp_cfg(p_dropout=0.1, **train):
    cfg = copy.deepcopy(TP_TINY)
    cfg["model"]["p_dropout"] = p_dropout
    cfg["train"].update(train)
    return cfg


def batch():
    """4 utterances: the first half has 12 phonemes and 24 frames, the
    second 7 and 17."""
    r = np.random.RandomState(0)
    wav = np.clip(r.randn(B, T * HOP, 1) * 0.2, -1, 1).astype(np.float32)
    out = dict(
        phonemes=torch.from_numpy(r.randint(1, N_VOCAB, size=(B, N))),
        phoneme_lengths=torch.tensor([6, 6, 4, 3]),
        f0=torch.from_numpy(r.uniform(80, 400, (B, N)).astype(np.float32)),
        energy=torch.from_numpy(r.uniform(30, 90, (B, N)).astype(np.float32)),
        duration=torch.from_numpy(DUR), spec=None,
        spec_lengths=torch.from_numpy(DUR.sum(1)), wav=torch.from_numpy(wav),
        sid=torch.tensor([0, 2, 1, 3]))
    eps = torch.from_numpy(r.randn(B, T, TP_TINY["model"]["inter_channels"]).astype(np.float32))
    return out, eps, torch.tensor([2, 4, 1, 0])


def steps(mesh, rows):
    """2 steps on the batch rows ``rows`` (dropout 0, injected noise and
    segments) → {"metrics" of each step averaged over the data axis,
    "grads" of each step and "params" after both, whole}, and the step."""
    cfg = config_from_dict(tp_cfg(p_dropout=0.0))
    g = random_init_(Synthesizer.from_config(cfg, N_VOCAB), SEED).eval()
    d = random_init_(MultiPeriodDiscriminator(PERIODS), SEED + 1).eval()
    plan = shard_model_(g, mesh.model_shard, require_match=True)

    def whole(name, t):
        return t if plan is None or t is None else plan.whole(name, t)

    step = TrainStep(cfg, g, d, steps_per_epoch=10, mesh=mesh, plan=plan)
    b, eps, ids = batch()
    part = {k: None if v is None else v[rows] for k, v in b.items()}
    out = {"metrics": [], "grads": []}
    for _ in range(2):
        m = step(part, eps_q=eps[rows], ids_slice=ids[rows])
        out["metrics"].append({k: float(v) for k, v in mesh.mean_metrics(m).items()})
        out["grads"].append({
            **{"g." + k: None if p.grad is None else whole(k, p.grad).clone()
               for k, p in g.named_parameters()},
            **{"d." + k: None if p.grad is None else p.grad.clone()
               for k, p in d.named_parameters()}})
    out["params"] = {**{"g." + k: whole(k, v) for k, v in g.state_dict().items()},
                     **{"d." + k: v for k, v in d.state_dict().items()}}
    out["sharded"] = sorted(plan.dims) if plan is not None else []
    return out, step


def streams(mesh, step):
    """This rank's first attention dropout keep mask and nn.Dropout draw."""
    seeds = torch.Generator().manual_seed(0)
    seeds.set_state(step.seed_generator.get_state())
    keep = rel_attention_train.dropout_keep(rel_attention_train.draw_seed(seeds), 0.1, 2, 2, 16)
    torch.manual_seed(mesh.seed(SEED))
    return keep, torch.nn.functional.dropout(torch.ones(64), 0.5)


def replicas(mesh):
    """``Mesh.average_grads_`` on three parameters whose gradients differ on
    every rank (1 + rank): a replicated one, a slice and a partial one;
    then ``check_replicas`` on two replicated parameters, equal and then
    one element apart on the last rank.  → (the three gradients, whether
    each check raised)."""
    ps = [torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)) for _ in range(3)]
    for p in ps:
        p.grad = torch.full_like(p, 1.0 + mesh.rank)
    replicated, sliced, partial = ps
    mesh.average_grads_(ps, [sliced], [partial])
    raised = []
    for apart in (False, True):
        w = torch.ones(4)
        if apart and mesh.rank == mesh.world_size - 1:
            w[2] = torch.nextafter(w[2], torch.tensor(2.0))
        try:
            mesh.check_replicas({"a": torch.ones(2, dtype=torch.bfloat16), "w": w})
            raised.append(False)
        except RuntimeError:
            raised.append(True)
    return [p.grad.clone() for p in ps], raised


def job_two_by_two(init, out_dir):
    """(data 2 × model 2): ``replicas``; data rank d on rows 2d, 2d + 1
    (unequal halves); then each model group alone, as a (data 1 × model 2)
    mesh, on the whole batch.  → ``quad{rank}.pt``: ``replicas``, both
    runs' ``steps`` and streams.  Then, in one process, rank 0 the
    ``steps`` and rank 1 the layers of the references (``refs_step.pt``,
    ``refs_layers.pt``)."""
    mesh = make_mesh(model=2, device="cpu", init_method=init)
    try:
        result = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
                  "replicas": replicas(mesh)}
        alone = dataclasses.replace(mesh, rank=mesh.model_rank, world_size=mesh.model_size,
                                    data_group=None)
        for name, m, rows in (("2x2", mesh, slice(2 * mesh.data_rank, 2 * mesh.data_rank + 2)),
                              ("1x2", alone, slice(0, B))):
            out, step = steps(m, rows)
            keep, drop = streams(m, step)
            result[name] = {**out, "keep": keep, "drop": drop}
        torch.save(result, os.path.join(out_dir, f"quad{mesh.rank}.pt"))
        if mesh.rank == 0:
            torch.save(steps(Mesh(), slice(0, B))[0], os.path.join(out_dir, "refs_step.pt"))
        elif mesh.rank == 1:
            torch.save(layer_grads(None), os.path.join(out_dir, "refs_layers.pt"))
    finally:
        mesh.close()


def job_model_axis_step(init, out_dir, cfg_dict, n_vocab, flat_g, flat_d, batch, eps, ids):
    """(data 1 × model 2): one step at learning rate 0 of the flax weights
    ``flat_g`` and ``flat_d`` (the scale discriminator and period 2) on the
    whole ``batch`` → ``rank{r}.pt`` with the metrics, the sharded
    parameters' names and every gradient, gathered whole.
    ``tests/test_torch_train.py`` holds it against JAX's step."""
    from vispeech_tpu_torch.utils.jax_weights import load_flax_params

    mesh = make_mesh(model=2, device="cpu", init_method=init)
    try:
        c = copy.deepcopy(cfg_dict)
        c["train"]["learning_rate"] = 0.0
        cfg = config_from_dict(c)
        g = load_flax_params(Synthesizer.from_config(cfg, n_vocab), flat_g, 1).eval()
        d = load_flax_params(MultiPeriodDiscriminator(PERIODS), flat_d,
                             discriminator=True).eval()
        plan = shard_model_(g, mesh.model_shard, require_match=True)
        step = TrainStep(cfg, g, d, steps_per_epoch=10, mesh=mesh, plan=plan)
        m = step(batch, eps_q=eps, ids_slice=ids)
        torch.save({"metrics": {k: float(v) for k, v in m.items()}, "sharded": sorted(plan.dims),
                    "g": {k: plan.whole(k, p.grad) for k, p in g.named_parameters()},
                    "d": {k: p.grad for k, p in d.named_parameters()}},
                   os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


# --- the layers, sharded on 2 ranks against the whole layer, in f64 ---------

def _layers():
    """name → (a model that holds the layer where the sharding rules find
    it, the layer, its input's shape), weights drawn from one seed."""
    gen = torch.Generator().manual_seed(7)
    layers = {
        "Conv1d": ("dec.conv_pre", Conv1d(16, 64, 7, padding=3), (2, 16, 13)),
        "WNConv1d": ("dec.resblocks.0.convs1.0", WNConv1d(64, 64, 3, dilation=3),
                     (2, 64, 13)),
        "WNConv1d, weight gathered": ("enc_q.enc.in_layers.0", WNConv1d(32, 64, 5),
                                      (2, 32, 13)),
        "WNConvTranspose1d": ("dec.ups.0", WNConvTranspose1d(128, 64, 8, 4), (2, 128, 9)),
        "ResBlock1": ("dec.resblocks.0", ResBlock1(64, 3, (1, 3)), (2, 64, 13)),
    }
    out = {}
    for name, (path, layer, shape) in layers.items():
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        root = mod = torch.nn.Module()
        *parents, leaf = path.split(".")
        for part in parents:
            mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.add_module(leaf, layer)
        out[name] = (root.double(), layer, shape)
    return out


def layer_grads(mesh, device="cpu"):
    """{layer: (output, input grad, {param: whole grad}, sharded names)} of
    each layer on the same input and output weights, on ``device``: whole
    in one process (``mesh`` None), else sharded, every gradient summed
    over the model group where a part, and gathered whole (CPU tensors)."""
    result = {}
    for name, (root, layer, shape) in _layers().items():
        gen = torch.Generator().manual_seed(11)
        root.to(device)
        x = torch.randn(shape, generator=gen, dtype=torch.float64).to(device).requires_grad_()
        plan = None if mesh is None else shard_model_(root, mesh.model_shard,
                                                      require_match=True)
        y = layer.forward_cf(x)
        w = torch.randn(y.shape, generator=gen, dtype=torch.float64).to(device)
        (y * w).sum().backward()
        params = dict(root.named_parameters())
        if plan is not None:
            all_reduce_mean_([params[k] for k in plan.partial], plan.shard.group, 1)
        grads = {k: (p.grad if plan is None else plan.whole(k, p.grad)).cpu()
                 for k, p in params.items()}
        result[name] = (y.detach().cpu(), x.grad.cpu(), grads,
                        [] if plan is None else sorted(plan.dims))
    return result


def job_layers_on_one_card(init, out_dir):
    """(data 1 × model 2) on ``cuda:0`` over gloo (NCCL takes one card a
    rank): ``layer_grads`` → ``card{rank}.pt``."""
    os.environ["LOCAL_RANK"] = "0"
    mesh = make_mesh(model=2, device="cuda", backend="gloo", init_method=init)
    try:
        torch.save(layer_grads(mesh, mesh.device), os.path.join(out_dir, f"card{mesh.rank}.pt"))
    finally:
        mesh.close()


# --- (data 1 × model 2): layers, step, streams, the Trainer ----------------

def _wait_for(path, timeout=90.0):
    """Until ``path`` exists (written whole, then renamed into place)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.1)


def small_discriminator(trainer_module):
    """The Trainer's discriminators cut to ``PERIODS`` (smaller checkpoints)."""
    trainer_module.MultiPeriodDiscriminator = lambda: MultiPeriodDiscriminator(PERIODS)


def _trainer(cfg_dict, data_root, save_dir, mesh=None):
    from vispeech_tpu_torch.train import loop

    small_discriminator(loop)
    c = json.loads(json.dumps(cfg_dict))
    c["train"]["save_dir"] = str(save_dir)
    return loop.Trainer(config_from_dict(c), data_root=data_root, device="cpu", mesh=mesh)


def _handover(src, dst_dir, mesh=None):
    """Copy checkpoint ``src``, once it is on disk, into ``dst_dir`` (rank
    0; whole before it appears there)."""
    _wait_for(src)
    if mesh is None or mesh.is_main:
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, os.path.basename(src))
        shutil.copy(src, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
    if mesh is not None:
        mesh.barrier()


def job_model_pair(init, out_dir, cfg_dict, data_root):
    """(data 1 × model 2): the layers; a Trainer of 2 steps (``tp``: its
    checkpoint, then its eval at step 2 on both ranks); a Trainer that
    resumes the one-process checkpoint ``one/ckpt_2.pt``
    (``job_one_process``): its state gathered whole, and its random
    streams.  → ``rank{rank}.pt``."""
    mesh = make_mesh(model=2, device="cpu", init_method=init)
    try:
        result = {"layers": layer_grads(mesh)}
        tp = _trainer(cfg_dict, data_root, os.path.join(out_dir, "tp"), mesh)
        tp.train(max_steps=2)
        result["eval"] = tp.evaluate(2)["audio"]
        _handover(os.path.join(out_dir, "one", "ckpt_2.pt"),
                  os.path.join(out_dir, "resumed"), mesh)
        resumed = _trainer(cfg_dict, data_root, os.path.join(out_dir, "resumed"), mesh)
        result["resumed_at"] = resumed.resume()
        result["resumed"] = {k: v for k, v in resumed.state_dict().items()
                             if k in ("model_g", "model_d", "optim_g", "optim_d")}
        result["resumed_rng"] = resumed.rng_state()
        torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


def job_one_process(init, out_dir, cfg_dict, data_root):
    """One-process Trainers: 4 steps (``one``, its step-2 checkpoint handed
    to ``job_model_pair``), and the model axis's step-2 checkpoint
    ``tp/ckpt_2.pt`` resumed to step 4 (``back``)."""
    one = _trainer(cfg_dict, data_root, os.path.join(out_dir, "one"))
    one.train(max_steps=2)
    one.train(max_steps=4)
    _handover(os.path.join(out_dir, "tp", "ckpt_2.pt"), os.path.join(out_dir, "back"))
    back = _trainer(cfg_dict, data_root, os.path.join(out_dir, "back"))
    torch.save({"back_at": back.resume()}, os.path.join(out_dir, "back_at.pt"))
    back.train(max_steps=4)
