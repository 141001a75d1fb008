"""Training checkpoints (``vispeech_tpu/utils/checkpoint.py``, in the port's
own format).

``ckpt_{step}.pt`` holds the generator and discriminator state dicts, both
optimizers, the step and the random generators' states, in one file: every
rank's under ``rank_rng`` (a list in rank order), rank 0's also at the top
level, where a checkpoint of one process without that list keeps them
(``rank_rng`` reads both).  Tensors are whole whatever model axis saved
them; ``model_parallel`` is its size.
``AsyncCheckpointer.save`` copies the state to host memory on the calling
thread (so the step loop may change the tensors at once), then writes,
renames atomically and prunes to the newest ``keep`` on a background
thread; an error there is raised at the next ``save`` or ``wait``.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("vispeech_tpu_torch")

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_path(base_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(base_dir), f"ckpt_{step}.pt")


def list_checkpoint_steps(base_dir: str) -> List[int]:
    if not os.path.isdir(base_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(base_dir)) if m)


def latest_checkpoint_step(base_dir: str) -> Optional[int]:
    """The largest saved step, or None."""
    steps = list_checkpoint_steps(base_dir)
    return steps[-1] if steps else None


def prune_checkpoints(base_dir: str, keep: int = 2) -> None:
    for step in list_checkpoint_steps(base_dir)[:-keep] if keep > 0 else []:
        try:
            os.remove(checkpoint_path(base_dir, step))
        except OSError:
            pass


def to_host(obj: Any) -> Any:
    """A copy of a (nested) state with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def save_checkpoint(base_dir: str, state: Dict, step: int, keep: int = 2) -> str:
    """Write ``state`` to ``ckpt_{step}.pt`` (renamed into place when
    whole), then prune to the newest ``keep``; → the path."""
    path = checkpoint_path(base_dir, step)
    os.makedirs(os.path.abspath(base_dir), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    logger.info("saved checkpoint at step %d -> %s", step, path)
    prune_checkpoints(base_dir, keep)
    return path


def load_checkpoint(base_dir: str, step: Optional[int] = None) -> Optional[Dict]:
    """The state saved at ``step`` (default: the latest), or None."""
    step = latest_checkpoint_step(base_dir) if step is None else step
    if step is None:
        return None
    return torch.load(checkpoint_path(base_dir, step), map_location="cpu", weights_only=False)


RNG_KEYS = ("generator", "seed_generator", "torch_rng", "cuda_rng")


def rank_rng(state: Dict, data_rank: int) -> Optional[Dict]:
    """The random states of data rank ``data_rank`` in checkpoint
    ``state``: those of the first rank of its model group (the group's
    ranks draw the same streams; ``model_parallel`` is the model size that
    saved it, 1 when absent), or None when fewer ranks saved it."""
    rngs = state.get("rank_rng") or [{k: state.get(k) for k in RNG_KEYS}]
    rank = data_rank * state.get("model_parallel", 1)
    return rngs[rank] if rank < len(rngs) else None


class AsyncCheckpointer:
    def __init__(self, keep: int = 2):
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, base_dir: str, state: Dict, step: int) -> str:
        self.wait()
        path = checkpoint_path(base_dir, step)
        snapshot = to_host(state)

        def write():
            try:
                save_checkpoint(base_dir, snapshot, step, self.keep)
            except BaseException as e:  # raised on the training thread
                self._error = e

        self._thread = threading.Thread(target=write, name=f"ckpt-{step}", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the write in flight is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
