"""The training loop (``vispeech_tpu/train/loop.py``), on one device or on
each rank of the data axis (``parallel/mesh.py``).

``Trainer``: filelist data with bucketed batches, collated on a thread into
pinned memory and copied one batch ahead; ``TrainStep`` (one GAN step);
the run directory holds ``config.json`` (which ``TTSEngine.
from_checkpoint`` reads beside the checkpoints), ``githash``,
``train.log``, TensorBoard scalars in ``tb/`` every ``log_interval`` steps
(the step's metrics, ``lr`` and ``steps_per_sec``) and eval outputs in
``tb_eval/`` every ``eval_interval`` steps: the first validation
utterance synthesized (``evaluate``), its mel, F0 and audio, before a
checkpoint.  Checkpoints also at ``max_steps`` and on SIGTERM;
``train_stats.json`` at the end.  ``train(profile_steps=(lo, hi))``
traces steps [lo, hi) into ``save_dir/profile`` (a Chrome trace) and logs
the device's peak memory over them.  ``resume`` restores the newest
``ckpt_*.pt``, or, when there is none, continues the JAX package's newest
``ckpt_*.npz`` (``utils/jax_weights.py``).

With a ``mesh`` of several data ranks each loads its share of every
global batch (``BucketSampler``'s ``num_replicas`` and ``rank``: every rank
draws the same bucket at a step) onto its own device, and the step
averages the gradients.  With a model axis (``--model-parallel``) the
ranks of one model group load the same share and draw the same random
streams, and the generator is sharded after it is built
(``parallel/sharding.py``, ``require_match``): each rank keeps its slice of
the sharded parameters and of their AdamW moments.  Checkpoints hold whole
tensors: every rank checks that its group's replicated parameters are
bit-equal and gathers its group's slices, rank 0 writes; a whole
state (the port's or a JAX checkpoint) is sliced on load, so either resumes
under any model size.  The ranks of data rank 0's model group run the eval
together (its decoder needs them all), and rank 0 writes it.

Rank 0 alone writes the run directory (logger file, ``config.json``,
``githash``, TensorBoard, evals, the profiler's trace,
``train_stats.json`` and the checkpoints, which hold every rank's random
generators, gathered; each rank restores its data rank's on resume).  The
ranks agree at each step whether any was asked to stop (SIGTERM or
``request_stop``), so all of them stop at the same step and none waits
forever in an all-reduce.  At log steps the metrics are averaged over the
ranks, so rank 0 logs the global batch's losses.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import time
from collections import deque
from contextlib import closing
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from vispeech_tpu_torch.config import Config, save_config
from vispeech_tpu_torch.data.dataset import (
    BucketSampler,
    FilelistDataset,
    bucket_phoneme_budgets,
    collate,
    data_loader,
    device_batches,
)
from vispeech_tpu_torch.dsp import mel_spectrogram, spec_to_mel
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops.policy import FLOAT32, resolve_device
from vispeech_tpu_torch.parallel import Mesh
from vispeech_tpu_torch.parallel.sharding import shard_model_
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.train.step import TrainStep, learning_rate
from vispeech_tpu_torch.utils import TrainLogger, check_git_hash, get_logger
from vispeech_tpu_torch.utils.checkpoint import AsyncCheckpointer, load_checkpoint, rank_rng
from vispeech_tpu_torch.utils.profiling import device_memory_stats, trace

logger = logging.getLogger("vispeech_tpu_torch")

EVAL_NOISE_SCALE = 0.667


def synthesize_utterance(model: Synthesizer, dataset: FilelistDataset, index: int = 0,
                         t_frames: int = 1024, noise_scale: float = EVAL_NOISE_SCALE,
                         seed: int = 0) -> dict:
    """``model.infer`` on utterance ``index`` of ``dataset``, collated at a
    frame budget of ``min(t_frames, 1400)`` on the model's device, in f32
    with TF32 off, the prior noise drawn from a ``torch.Generator`` seeded
    with ``seed`` (no other random stream is touched).  → {"audio": the
    waveform cut to the synthesized frames × hop, "n_frames", "f0" (the
    predicted phoneme F0 [Hz]), "batch": the collated numpy batch}."""
    device = next(model.parameters()).device
    raw = collate(dataset, [index], frame_budget=min(t_frames, 1400), device_dsp=False)

    def dev(a):
        return torch.as_tensor(a, device=device)

    generator = torch.Generator(device=device).manual_seed(seed)
    with FLOAT32.precision():
        audio, frame_mask, _, _, f0, _ = model.infer(
            dev(raw["phonemes"]), dev(raw["phoneme_lengths"]), raw["spec"].shape[1],
            sid=dev(raw["sid"]), noise_scale=noise_scale, generator=generator)
    n_frames = int(frame_mask.sum())
    hop = dataset.cfg.hop_length
    return {"audio": audio[0, :n_frames * hop, 0].float().cpu().numpy(), "n_frames": n_frames,
            "f0": f0[0].float().cpu().numpy(), "batch": raw}


class Trainer:
    """GAN trainer: data, step, logging, checkpoints.  ``mesh`` (from
    ``parallel.make_mesh``) puts it on a rank of the data axis, on the
    mesh's device; None means one process on ``device`` (None: the GPU)."""

    def __init__(self, cfg: Config, data_root: str = "dataset", device: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        if mesh is not None and device is not None and resolve_device(device).type \
                != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.mesh = mesh or Mesh(device=resolve_device(device))
        self.device = self.mesh.device
        self.main = self.mesh.is_main
        self.save_dir = cfg.train.save_dir
        get_logger(self.save_dir if self.main else None)
        self.tb = self.tb_eval = None
        if self.main:
            save_config(cfg, os.path.join(self.save_dir, "config.json"))
            check_git_hash(self.save_dir)
            self.tb = TrainLogger(os.path.join(self.save_dir, "tb"))
            self.tb_eval = TrainLogger(os.path.join(self.save_dir, "tb_eval"))
        torch.manual_seed(self.mesh.seed(cfg.train.seed))   # nn.Dropout's stream

        self.train_set = FilelistDataset(cfg.data.training_files, cfg.data, data_root)
        self.val_set = FilelistDataset(cfg.data.validation_files, cfg.data, data_root)
        self.sampler = BucketSampler(self.train_set.lengths, cfg.train.batch_size,
                                     num_replicas=self.mesh.data_size,
                                     rank=self.mesh.data_rank,
                                     seed=cfg.train.seed)
        self.steps_per_epoch = max(len(self.sampler), 1)
        self.phoneme_budgets = bucket_phoneme_budgets(self.train_set, self.sampler)
        logger.info("train: %d utterances, val: %d utterances, %d steps/epoch, device %s, "
                    "rank %d of %d (model axis %d), buckets (T → N) %s", len(self.train_set),
                    len(self.val_set), self.steps_per_epoch, self.device, self.mesh.rank,
                    self.mesh.world_size, self.mesh.model_size,
                    {self.sampler.buckets[b]: n for b, n in self.phoneme_budgets.items()})

        seed = cfg.train.seed
        self.model_g = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed)
        self.model_d = random_init_(MultiPeriodDiscriminator(), seed + 1)
        self.model_g.to(self.device).train()
        self.model_d.to(self.device).train()
        self.plan = shard_model_(self.model_g, self.mesh.model_shard, require_match=True)
        self.step_fn = TrainStep(cfg, self.model_g, self.model_d, self.steps_per_epoch,
                                 mesh=self.mesh, plan=self.plan)
        self._checkpointer = AsyncCheckpointer(keep=2)
        self._stop_requested = False
        self._trace: Optional[contextlib.ExitStack] = None
        # each device's memory at the end of the last trace (peak: over it)
        self.profile_memory: dict = {}
        self.shapes_seen: set = set()
        # (frames, host seconds to enqueue the step): the device runs behind
        self.step_times: deque = deque(maxlen=50_000)

    @property
    def global_step(self) -> int:
        return self.step_fn.step

    def rng_state(self) -> dict:
        """This rank's random generators' states."""
        s = self.step_fn
        return {"generator": s.generator.get_state(),
                "seed_generator": s.seed_generator.get_state(),
                "torch_rng": torch.get_rng_state(),
                # nn.Dropout on the card draws from the device's default stream
                "cuda_rng": (torch.cuda.get_rng_state(self.device)
                             if self.device.type == "cuda" else None)}

    def state_dict(self, rank_rngs: Optional[list] = None) -> dict:
        """The checkpoint: parameters and moments whole (replicated across
        the data axis, so this rank's are every rank's; with a model axis
        gathered over the model group, a collective every rank of the group
        calls), the step, the model size, and ``rank_rngs`` (every rank's
        ``rng_state``, default this one's alone), rank 0's also at the top
        level, where a one-process checkpoint keeps them."""
        s = self.step_fn
        rngs = rank_rngs or [self.rng_state()]
        model_g, optim_g = self.model_g.state_dict(), s.opt_g.state_dict()
        if self.plan is not None:
            model_g = self.plan.whole_state(model_g)
            optim_g = self._map_moments(optim_g, self.plan.whole)
        return {"step": s.step, "model_g": model_g,
                "model_d": self.model_d.state_dict(), "optim_g": optim_g,
                "optim_d": s.opt_d.state_dict(), **rngs[0], "rank_rng": rngs,
                "model_parallel": self.mesh.model_size}

    def _map_moments(self, optim_state: dict, fn) -> dict:
        """``optim_state`` (the generator's) with each AdamW moment ``t`` of
        parameter ``name`` replaced by ``fn(name, t)``, in index order."""
        names = {id(p): n for n, p in self.model_g.named_parameters()}
        order = [names[id(p)] for g in self.step_fn.opt_g.param_groups for p in g["params"]]
        moments = {i: {k: fn(order[i], v) if k in ("exp_avg", "exp_avg_sq") else v
                       for k, v in st.items()}
                   for i, st in sorted(optim_state["state"].items())}
        return {**optim_state, "state": moments}

    def load_state_dict(self, state: dict) -> None:
        """Restore a checkpoint of whole tensors (sliced under a model
        axis); each rank takes the random states of its data rank."""
        s = self.step_fn
        model_g, optim_g = state["model_g"], state["optim_g"]
        if self.plan is not None:
            model_g = self.plan.own_state(model_g)
            optim_g = self._map_moments(optim_g, self.plan.own)
        self.model_g.load_state_dict(model_g)
        self.model_d.load_state_dict(state["model_d"])
        s.opt_g.load_state_dict(optim_g)
        s.opt_d.load_state_dict(state["optim_d"])
        rng = rank_rng(state, self.mesh.data_rank)
        if rng is None:   # saved by fewer ranks: this one keeps its fresh streams
            logger.warning("rank %d: the checkpoint holds no random state for it",
                           self.mesh.rank)
        else:
            s.generator.set_state(rng["generator"])
            s.seed_generator.set_state(rng["seed_generator"])
            torch.set_rng_state(rng["torch_rng"])
            if rng.get("cuda_rng") is not None and self.device.type == "cuda":
                torch.cuda.set_rng_state(rng["cuda_rng"], self.device)
        s.step = int(state["step"])

    def resume(self) -> Optional[int]:
        """Restore the newest checkpoint of the save directory; returns its
        step, or None when there is none."""
        state = load_checkpoint(self.save_dir)
        if state is not None:
            self.load_state_dict(state)
            logger.info("resumed at step %d", self.global_step)
            return self.global_step
        from vispeech_tpu_torch.utils import jax_weights

        step = jax_weights.load_jax_checkpoint(self.save_dir, self.model_g, self.model_d,
                                               self.step_fn.opt_g, self.step_fn.opt_d,
                                               len(self.cfg.model.resblock_kernel_sizes),
                                               self.plan)
        if step is not None:
            self.step_fn.step = step
            logger.info("continued the JAX checkpoint at step %d", step)
        return step

    def request_stop(self) -> None:
        """Checkpoint and leave the loop at the next step boundary."""
        self._stop_requested = True

    def _save(self, step: int) -> None:
        """Every rank: check that its model group's replicated parameters
        are equal, gather the random states and the model axis's slices;
        rank 0: write."""
        if self.plan is not None:
            self.mesh.check_replicas({
                **{f"model_g.{k}": p for k, p in self.model_g.named_parameters()
                   if k not in self.plan.dims},
                **{f"model_d.{k}": p for k, p in self.model_d.named_parameters()}})
        rngs = self.mesh.gather(self.rng_state())
        state = self.state_dict(rngs)
        if self.main:
            self._checkpointer.save(self.save_dir, state, step)

    def train(self, max_steps: Optional[int] = None,
              profile_steps: Optional[Tuple[int, int]] = None) -> None:
        """Train up to ``max_steps``; ``profile_steps=(lo, hi)`` traces the
        steps [lo, hi) into ``save_dir/profile``."""
        self._stop_requested = False
        old = None
        try:
            old = signal.signal(signal.SIGTERM, lambda *_: self.request_stop())
        except ValueError:  # not the main thread
            pass
        try:
            self._loop(max_steps, profile_steps)
            # rank 0's last checkpoint is on disk before any rank returns
            # (and may resume from it)
            self._checkpointer.wait()
            self.mesh.barrier()
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
            self._stop_profile()
            self._checkpointer.wait()
            if self.main:
                self.tb.flush()
                self.tb_eval.flush()
                self._write_stats()

    def _start_profile(self, step: int) -> None:
        if self._trace is None:
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self._trace = contextlib.ExitStack()
            self._trace.enter_context(trace(os.path.join(self.save_dir, "profile"), step))
            logger.info("profiler trace started at step %d -> %s/profile", step, self.save_dir)

    def _stop_profile(self) -> None:
        if self._trace is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._trace.close()
            self._trace = None
            self.profile_memory = device_memory_stats()
            for dev, s in self.profile_memory.items():
                logger.info("profiler trace stopped; %s peak memory %.1f MiB / %.1f MiB",
                            dev, s["peak_bytes_in_use"] / 2**20, s["bytes_limit"] / 2**20)

    def batches(self, start_epoch: int = 0) -> Iterator[Tuple[int, dict]]:
        """(epoch, batch on the device), epoch after epoch from
        ``start_epoch``: the loop's input pipeline."""
        for epoch in range(start_epoch, self.cfg.train.epochs):
            host = data_loader(self.train_set, self.sampler, epoch,
                               phoneme_budgets=self.phoneme_budgets,
                               device_dsp=self.cfg.train.device_dsp)
            try:
                for batch in device_batches(host, self.device):
                    yield epoch, batch
            finally:
                host.close()   # stops the loader's thread when the consumer stops early

    def _loop(self, max_steps: Optional[int], profile_steps) -> None:
        cfg = self.cfg
        start_epoch = self.global_step // self.steps_per_epoch
        logger.info("starting at step %d (epoch %d)", self.global_step, start_epoch)
        t0 = time.time()
        with closing(self.batches(start_epoch)) as batches:
            for epoch, batch in batches:
                step = self.global_step
                if profile_steps is not None and self.main:
                    if step >= profile_steps[1]:
                        self._stop_profile()
                    elif step >= profile_steps[0]:
                        self._start_profile(step)
                stop = self.mesh.any(self._stop_requested)
                if stop or (max_steps is not None and step >= max_steps):
                    if stop:
                        logger.info("stop requested: saving at step %d", step)
                    self._save(step)
                    return
                shape = (batch["wav"].shape[1] // cfg.data.hop_length,
                         batch["phonemes"].shape[1])
                if shape not in self.shapes_seen:
                    self.shapes_seen.add(shape)
                    logger.info("step %d: new batch shape T=%d N=%d", step, *shape)
                t_step = time.perf_counter()
                metrics = self.step_fn(batch)
                self.step_times.append((shape[0], time.perf_counter() - t_step))
                step += 1
                if step % cfg.train.log_interval == 0:
                    dt = time.time() - t0
                    t0 = time.time()
                    metrics = self.mesh.mean_metrics(metrics)   # the global batch's
                    if self.main:
                        m = {k: float(v) for k, v in metrics.items()}
                        m["lr"] = learning_rate(cfg, step, self.steps_per_epoch)
                        m["steps_per_sec"] = cfg.train.log_interval / max(dt, 1e-9)
                        self.tb.scalars(step, m)
                        logger.info(
                            "epoch %d step %d: g=%.3f d=%.3f mel=%.3f kl=%.3f lr=%.3g "
                            "(%.2f steps/s)", epoch, step, m["loss/g/total"],
                            m["loss/d/total"], m["loss/g/mel"], m["loss/g/kl"], m["lr"],
                            m["steps_per_sec"])
                if step % cfg.train.eval_interval == 0:
                    if self.mesh.data_rank == 0:   # rank 0's model group
                        self.evaluate(step)
                    self._save(step)
        self._save(self.global_step)

    def evaluate(self, step: int, t_frames: int = 1024) -> Optional[dict]:
        """Synthesize the first validation utterance at noise scale 0.667,
        the prior noise seeded by ``step`` (the training streams untouched),
        and log to ``tb_eval``: the generated and ground-truth audio, and
        where the writer records images (tensorboardX) and matplotlib can
        be imported, the ground-truth and generated mels and the F0 plot.
        → ``synthesize_utterance``'s dict, None without a validation set.
        With a model axis every rank of the model group calls it; rank 0
        alone logs."""
        if len(self.val_set) == 0:
            return None
        d = self.cfg.data
        out = synthesize_utterance(self.model_g, self.val_set, 0, t_frames, seed=step)
        if not self.main:
            return out
        raw = out["batch"]
        if self.tb_eval.records_media:
            try:
                self._eval_images(step, out)
            except ImportError as e:   # matplotlib is optional
                logger.warning("eval @ step %d: no images (%s)", step, e)
        self.tb_eval.audio(step, "eval/audio_gen", out["audio"], d.sampling_rate)
        gt_wav = raw["wav"][0, :int(raw["wav_lengths"][0]), 0]
        self.tb_eval.audio(step, "eval/audio_gt", gt_wav, d.sampling_rate)
        self.tb_eval.flush()
        logger.info("eval @ step %d: %d frames synthesized", step, out["n_frames"])
        return out

    def _eval_images(self, step: int, out: dict) -> None:
        from vispeech_tpu_torch.utils.plotting import line_plot_image, spectrogram_image

        d, raw = self.cfg.data, out["batch"]
        gt_spec = torch.from_numpy(raw["spec"][:1, :int(raw["spec_lengths"][0])])
        gt_mel = spec_to_mel(gt_spec, d.filter_length, d.n_mel_channels, d.sampling_rate,
                             d.mel_fmin, d.mel_fmax)[0].numpy()
        gen_mel = mel_spectrogram(torch.from_numpy(out["audio"][None]), d.filter_length,
                                  d.n_mel_channels, d.sampling_rate, d.hop_length,
                                  d.win_length, d.mel_fmin, d.mel_fmax)[0].numpy()
        n_ph = int(raw["phoneme_lengths"][0])
        self.tb_eval.image(step, "eval/mel_gt", spectrogram_image(gt_mel) / 255.0)
        self.tb_eval.image(step, "eval/mel_gen", spectrogram_image(gen_mel) / 255.0)
        self.tb_eval.image(step, "eval/f0", line_plot_image(
            [raw["f0"][0, :n_ph], out["f0"][:n_ph]], ["gt", "pred"],
            title="phoneme F0 (Hz)") / 255.0)

    def _write_stats(self) -> None:
        by_bucket: dict = {}
        for frames, dt in self.step_times:
            by_bucket.setdefault(frames, []).append(dt)
        stats = {
            "global_step": self.global_step,
            "device": str(self.device),
            "batch_shapes": sorted(self.shapes_seen),
            # host time to enqueue a step, not device time (no sync per step)
            "enqueue_ms_by_bucket": {
                str(k): {"n": len(v), "median_ms": 1e3 * float(np.median(v))}
                for k, v in sorted(by_bucket.items())},
        }
        with open(os.path.join(self.save_dir, "train_stats.json"), "w") as f:
            json.dump(stats, f, indent=1)
