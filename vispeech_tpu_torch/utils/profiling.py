"""Profiling hooks (``vispeech_tpu/utils/profiling.py``) over
``torch.profiler``:

- ``trace(logdir, step)``: a context that records the host and (where
  there is a GPU) the device, and writes a Chrome trace into ``logdir``
  (open it in Perfetto or ``chrome://tracing``);
- ``annotate(name)``: a named range on the host timeline;
- ``device_memory_stats()``: each CUDA device's allocated, peak allocated
  and total bytes; ``{}`` where there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, step: Optional[int] = None):
    """Record the body; on exit write ``logdir/trace_step_{step}.json``
    (``trace.json`` without a step).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    name = "trace.json" if step is None else f"trace_step_{step}.json"
    with profile(activities=activities) as prof:
        if step is None:
            yield prof
        else:
            with record_function(f"train_step_{step}"):
                yield prof
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """``with annotate("data_load"): ...`` — a range on the host timeline."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        out[str(dev)] = {
            "bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        }
    return out
