"""Checkpoints, logging, plotting, profiling and FLOP accounting
(``vispeech_tpu/utils``)."""

from vispeech_tpu_torch.utils.checkpoint import (
    latest_checkpoint_step,
    load_checkpoint,
    prune_checkpoints,
    save_checkpoint,
)
from vispeech_tpu_torch.utils.logging import TrainLogger, check_git_hash, get_logger

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint_step",
    "prune_checkpoints",
    "TrainLogger",
    "get_logger",
    "check_git_hash",
]
