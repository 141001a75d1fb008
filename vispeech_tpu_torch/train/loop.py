"""The training loop (``vispeech_tpu/train/loop.py``) on one device.

``Trainer``: filelist data with bucketed batches, collated on a thread into
pinned memory and copied one batch ahead; ``TrainStep`` (one GAN step);
``log_interval`` scalars through ``logging`` (``train.log`` in the save
directory); a checkpoint every ``eval_interval`` steps, at ``max_steps``
and on SIGTERM; ``train_stats.json`` at the end.  ``resume`` restores the
newest ``ckpt_*.pt``, or, when there is none, continues the JAX package's
newest ``ckpt_*.npz`` (``utils/jax_weights.py``).

Not ported yet (``ROADMAP.md`` queue 1): the data × model mesh (the CLI
refuses ``--model-parallel`` > 1), the profiler trace, and the TensorBoard
scalars and eval images (the loop says so in its log once).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from vispeech_tpu_torch.config import Config
from vispeech_tpu_torch.data.dataset import (
    BucketSampler,
    FilelistDataset,
    bucket_phoneme_budgets,
    data_loader,
    device_batches,
)
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops.policy import resolve_device
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.train.step import TrainStep, learning_rate
from vispeech_tpu_torch.utils.checkpoint import AsyncCheckpointer, load_checkpoint

logger = logging.getLogger("vispeech_tpu_torch")


def _file_logger(save_dir: str) -> None:
    path = os.path.abspath(os.path.join(save_dir, "train.log"))
    if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)


class Trainer:
    """GAN trainer: data, step, logging, checkpoints.  ``device`` None
    means the GPU."""

    def __init__(self, cfg: Config, data_root: str = "dataset", device: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.save_dir = cfg.train.save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        _file_logger(self.save_dir)
        torch.manual_seed(cfg.train.seed)   # nn.Dropout's stream

        self.train_set = FilelistDataset(cfg.data.training_files, cfg.data, data_root)
        self.sampler = BucketSampler(self.train_set.lengths, cfg.train.batch_size,
                                     seed=cfg.train.seed)
        self.steps_per_epoch = max(len(self.sampler), 1)
        self.phoneme_budgets = bucket_phoneme_budgets(self.train_set, self.sampler)
        logger.info("train: %d utterances, %d steps/epoch, device %s, buckets (T → N) %s",
                    len(self.train_set), self.steps_per_epoch, self.device,
                    {self.sampler.buckets[b]: n for b, n in self.phoneme_budgets.items()})
        logger.warning("TensorBoard scalars, eval synthesis and images are not ported yet "
                       "(ROADMAP.md queue 1 item 9): scalars go to this log only")

        seed = cfg.train.seed
        self.model_g = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), seed)
        self.model_d = random_init_(MultiPeriodDiscriminator(), seed + 1)
        self.model_g.to(self.device).train()
        self.model_d.to(self.device).train()
        self.step_fn = TrainStep(cfg, self.model_g, self.model_d, self.steps_per_epoch)
        self._checkpointer = AsyncCheckpointer(keep=2)
        self._stop_requested = False
        self.shapes_seen: set = set()
        # (frames, host seconds to enqueue the step): the device runs behind
        self.step_times: deque = deque(maxlen=50_000)

    @property
    def global_step(self) -> int:
        return self.step_fn.step

    def state_dict(self) -> dict:
        s = self.step_fn
        return {"step": s.step, "model_g": self.model_g.state_dict(),
                "model_d": self.model_d.state_dict(), "optim_g": s.opt_g.state_dict(),
                "optim_d": s.opt_d.state_dict(), "generator": s.generator.get_state(),
                "seed_generator": s.seed_generator.get_state(),
                "torch_rng": torch.get_rng_state(),
                # nn.Dropout on the card draws from the device's default stream
                "cuda_rng": (torch.cuda.get_rng_state(self.device)
                             if self.device.type == "cuda" else None)}

    def load_state_dict(self, state: dict) -> None:
        s = self.step_fn
        self.model_g.load_state_dict(state["model_g"])
        self.model_d.load_state_dict(state["model_d"])
        s.opt_g.load_state_dict(state["optim_g"])
        s.opt_d.load_state_dict(state["optim_d"])
        s.generator.set_state(state["generator"])
        s.seed_generator.set_state(state["seed_generator"])
        torch.set_rng_state(state["torch_rng"])
        if state.get("cuda_rng") is not None and self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda_rng"], self.device)
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
                                               len(self.cfg.model.resblock_kernel_sizes))
        if step is not None:
            self.step_fn.step = step
            logger.info("continued the JAX checkpoint at step %d", step)
        return step

    def request_stop(self) -> None:
        """Checkpoint and leave the loop at the next step boundary."""
        self._stop_requested = True

    def _save(self, step: int) -> None:
        self._checkpointer.save(self.save_dir, self.state_dict(), step)

    def train(self, max_steps: Optional[int] = None) -> None:
        self._stop_requested = False
        old = None
        try:
            old = signal.signal(signal.SIGTERM, lambda *_: self.request_stop())
        except ValueError:  # not the main thread
            pass
        try:
            self._loop(max_steps)
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
            self._checkpointer.wait()
            self._write_stats()

    def batches(self, start_epoch: int = 0) -> Iterator[Tuple[int, dict]]:
        """(epoch, batch on the device), epoch after epoch from
        ``start_epoch``: the loop's input pipeline."""
        for epoch in range(start_epoch, self.cfg.train.epochs):
            host = data_loader(self.train_set, self.sampler, epoch,
                               phoneme_budgets=self.phoneme_budgets,
                               device_dsp=self.cfg.train.device_dsp)
            for batch in device_batches(host, self.device):
                yield epoch, batch

    def _loop(self, max_steps: Optional[int]) -> None:
        cfg = self.cfg
        start_epoch = self.global_step // self.steps_per_epoch
        logger.info("starting at step %d (epoch %d)", self.global_step, start_epoch)
        t0 = time.time()
        for epoch, batch in self.batches(start_epoch):
            step = self.global_step
            if self._stop_requested or (max_steps is not None and step >= max_steps):
                if self._stop_requested:
                    logger.info("stop requested: saving at step %d", step)
                self._save(step)
                return
            shape = (batch["wav"].shape[1] // cfg.data.hop_length, batch["phonemes"].shape[1])
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
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    "epoch %d step %d: g=%.3f d=%.3f mel=%.3f kl=%.3f lr=%.3g "
                    "(%.2f steps/s)", epoch, step, m["loss/g/total"], m["loss/d/total"],
                    m["loss/g/mel"], m["loss/g/kl"],
                    learning_rate(cfg, step, self.steps_per_epoch),
                    cfg.train.log_interval / max(dt, 1e-9))
            if step % cfg.train.eval_interval == 0:
                self._save(step)
        self._save(self.global_step)

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
