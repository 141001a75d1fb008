"""The spawned ranks of ``tests/test_torch_context.py`` and
``tests/test_torch_pipeline.py`` (context parallelism and the two-stage
pipeline on the CPU, gloo).  A module of its own, which imports no JAX:
each spawned rank imports it afresh.  ``test_torch_ddp.Job`` starts them;
each rank saves what it got to ``out/{job}_rank{r}.pt``."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.models.synthesizer import Synthesizer
from vispeech_tpu_torch.parallel import p2p
from vispeech_tpu_torch.parallel.context import (
    context_groups,
    make_generator_context_parallel,
    make_ring_attention,
)
from vispeech_tpu_torch.parallel.pipeline import make_synthesizer_pipeline
from vispeech_tpu_torch.utils.jax_weights import load_flax_params

# a collective or hop that waits longer than this raises, within the join's
# timeout: a rank whose peer died fails instead of hanging its job
GROUP_TIMEOUT = 90

# tests/test_context_parallel.py's ring sizes
RING = dict(B=2, H=2, T=256, d=32, w=4)
# its generator (hop 64), and the latent it decodes
GEN = dict(initial_channel=32, resblock="1", resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 4, 2, 2),
           upsample_initial_channel=64, upsample_kernel_sizes=(8, 8, 4, 4), gin_channels=16)
HOP, HALO = 64, 32
# its parameters: "init", the JAX test's (flax init at key 0), whose audio
# hardly depends on z (std 1.2e-3; a frame's sign moves it by 1.4e-5, below
# the tests' 1e-4), and "drawn" with numpy, whose audio does (std 0.17; a
# frame's sign moves it by 0.24), so that a wrong halo shows
GENERATOR_PARAMS = ("init", "drawn")
VOC = dict(B=2, T=256, C=32, G=16)

# tests/test_pipeline.py's TINY and its inputs
TINY = {
    "train": {"segment_size": 256},
    "data": {"sampling_rate": 16000, "filter_length": 128, "hop_length": 64,
             "win_length": 128, "n_speakers": 4},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0,
              "resblock": "1", "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [8, 4, 2],
              "upsample_initial_channel": 64, "upsample_kernel_sizes": [16, 8, 4],
              "gin_channels": 8},
}
PIPE = dict(B=4, N=8, T=32, n_vocab=40)


def ring_inputs():
    """q, k, v [B, H, T, d], rel_k, rel_v [2w+1, d], key mask [B, T] of
    lengths [T, T − 50], as numpy f32."""
    B, H, T, d, w = (RING[k] for k in "BHTdw")
    r = np.random.RandomState(0)
    q, k, v = (r.randn(B, H, T, d).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((r.randn(2 * w + 1, d) * d ** -0.5).astype(np.float32) for _ in range(2))
    mask = (np.arange(T)[None, :] < np.array([T, T - 50])[:, None]).astype(np.float32)
    return q, k, v, rel_k, rel_v, mask


def vocoder_inputs():
    """z [B, T, C] and g [B, 1, G], numpy f32."""
    r = np.random.RandomState(1)
    return (r.randn(VOC["B"], VOC["T"], VOC["C"]).astype(np.float32),
            r.randn(VOC["B"], 1, VOC["G"]).astype(np.float32))


def pipeline_inputs():
    """phonemes, lengths, sid, eps of ``PIPE``'s batch, numpy."""
    B, N, T = PIPE["B"], PIPE["N"], PIPE["T"]
    r = np.random.RandomState(0)
    ph = r.randint(1, PIPE["n_vocab"], (B, N)).astype(np.int64)
    lens = np.array([N, N - 1, N, N - 3], np.int64)
    sid = r.randint(0, 4, (B,)).astype(np.int64)
    eps = r.randn(B, T, TINY["model"]["inter_channels"]).astype(np.float32)
    return ph, lens, sid, eps


def generator(flat):
    n = len(GEN["resblock_kernel_sizes"])
    return load_flax_params(Generator(**GEN), flat, n_resblock_kernels=n).eval()


def synthesizer(flat):
    cfg = config_from_dict(TINY)
    model = Synthesizer.from_config(cfg, PIPE["n_vocab"])
    return load_flax_params(model, flat, len(TINY["model"]["resblock_kernel_sizes"])).eval()


def _init(init):
    dist.init_process_group("gloo", init_method=init, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    return dist.get_rank()


def _raised(fn, *args):
    """The message of the exception ``fn(*args)`` raises (None: it did not)."""
    try:
        fn(*args)
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def job_context(init, out, params_path):
    """4 ranks: ``p2p.shift``; ring attention over the world (P = 4), over
    the two context groups {0, 1}, {2, 3} (P = 2) and at data 2 × context
    2; the overlap-save vocoder at P = 4 and at data 2 × context 2 with each
    of ``GENERATOR_PARAMS`` (``params_path``: {name: .npz}); the guards."""
    rank = _init(init)
    got = {}
    world, _ = context_groups(4)
    ctx2, data2 = context_groups(2, 2)

    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    got["shift"] = {off: p2p.shift(x, world, off) for off in (1, -1, 2, 4)}
    got["shift_many"] = p2p.shift((x, x.long() * 3, x[:2].clone()), world, 1)
    got["shift_pair"] = p2p.shift(x, ctx2, 1)

    args = [torch.from_numpy(a) for a in ring_inputs()]
    with torch.no_grad():
        got["ring4"] = make_ring_attention(world, RING["w"])(*args)
        got["ring2"] = make_ring_attention(ctx2, RING["w"])(*args)
        got["ring2x2"] = make_ring_attention(ctx2, RING["w"], batch_group=data2)(*args)

    z, g = (torch.from_numpy(a) for a in vocoder_inputs())
    for which in GENERATOR_PARAMS:
        gen = generator(dict(np.load(params_path[which])))
        with torch.no_grad():
            got[f"vocoder4_{which}"] = make_generator_context_parallel(gen, world, HOP, HALO)(
                z[:1], g[:1])
            got[f"vocoder2x2_{which}"] = make_generator_context_parallel(
                gen, ctx2, HOP, HALO, batch_group=data2)(z, g)
    # every guard raises on every rank, before any hop
    cp4 = make_generator_context_parallel(gen, world, HOP, HALO)
    ring4 = make_ring_attention(world, RING["w"])
    q, k, v, rel_k, rel_v, mask = args
    got["guards"] = {
        "vocoder T % P": _raised(cp4, z[:1, :254], g[:1]),
        "vocoder T/P < halo": _raised(cp4, z[:1, :120], g[:1]),
        "vocoder B % data": _raised(make_generator_context_parallel(
            gen, ctx2, HOP, HALO, batch_group=data2), z[:1], g[:1]),
        "ring T % P": _raised(ring4, q[:, :, :254], k[:, :, :254], v[:, :, :254], rel_k,
                              rel_v, mask[:, :254]),
        "ring B % data": _raised(make_ring_attention(ctx2, RING["w"], batch_group=data2),
                                 q[:1], k[:1], v[:1], rel_k, rel_v, mask[:1]),
        "ring requires grad": _raised(ring4, q.clone().requires_grad_(), k, v, rel_k,
                                      rel_v, mask),
    }
    torch.save(got, os.path.join(out, f"context_rank{rank}.pt"))
    dist.destroy_process_group()


def job_rank_raises(init, out, params_path):
    """2 ranks of the vocoder, whose generator raises on rank 1: rank 0 waits
    for rank 1's output chunk, and must fail (not hang) once its peer is
    gone.  Each rank marks that it got past the rendezvous."""
    rank = _init(init)
    gen = generator(dict(np.load(params_path["init"])))
    group, _ = context_groups(2)
    open(os.path.join(out, f"raises_ready_{rank}"), "w").close()

    def apply(z_ext, g):
        if rank == 1:
            raise RuntimeError("rank 1's generator failed")
        return gen(z_ext, g)

    z, g = (torch.from_numpy(a[:1]) for a in vocoder_inputs())
    with torch.no_grad():
        make_generator_context_parallel(apply, group, HOP, HALO)(z, g)
    dist.destroy_process_group()


def job_pipeline(init, out, params_path):
    """4 ranks: a 4-rank group refused ('stage'); the stage pairs {0, 1} at
    M = 2 and {2, 3} at M = 4, each with B % M ≠ 0 refused."""
    rank = _init(init)
    model = synthesizer(dict(np.load(params_path)))
    ph, lens, sid, eps = (torch.from_numpy(a) for a in pipeline_inputs())
    got = {"world": _raised(make_synthesizer_pipeline, model, dist.group.WORLD, PIPE["T"], 2)}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = pairs[rank // 2]
    M = 2 if rank < 2 else 4
    got["M"] = M
    got["audio"] = make_synthesizer_pipeline(model, group, PIPE["T"], M)(ph, lens, sid, eps)
    got["B % M"] = _raised(make_synthesizer_pipeline(model, group, PIPE["T"], 3),
                           ph, lens, sid, eps)
    got["no eps"] = _raised(make_synthesizer_pipeline(model, group, PIPE["T"], M),
                            ph, lens, sid, None)
    torch.save(got, os.path.join(out, f"pipeline_rank{rank}.pt"))
    dist.destroy_process_group()
