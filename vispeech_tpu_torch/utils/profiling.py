"""Profiling hooks (``vispeech_tpu/utils/profiling.py``) over
``torch.profiler``, and the program's own span and counter recorder:

- ``trace(logdir, step)``: a context that records the host and (where
  there is a GPU) the device, and writes a Chrome trace into ``logdir``
  (open it in Perfetto or ``chrome://tracing``);
- ``device_memory_stats()``: each CUDA device's allocated, peak allocated
  and total bytes; ``{}`` where there is no CUDA device;
- ``span(name)``, ``count(name, n)``, ``enable()``, ``disable()``,
  ``drain()``, ``clock_ns()``: one recorder for the process
  (``Recorder``).  Off until ``enable()``; while off, ``span()`` returns
  one shared no-op context and ``count()`` returns at once: no span
  object, no clock read, no device call.

Span times are on the clock ``torch.profiler`` stamps its events with
(Unix-epoch nanoseconds): ``perf_counter_ns()`` plus the offset to
``time.time_ns()`` read at ``enable()``, so that spans nest on a monotonic
clock and sit on a device trace's timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

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


class _Off:
    """The span of a recorder that is off: one shared object, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "call", "start", "child_ns")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.id = next(self.rec._ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        self.child_ns = 0
        stack.append(self)
        self.start = self.rec.clock_ns()
        return self

    def __exit__(self, *exc):
        end = self.rec.clock_ns()
        stack = self.rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start
        self.rec._add({"id": self.id, "parent": self.parent, "call": self.call,
                       "thread": threading.get_ident(), "name": self.name,
                       "start_ns": self.start, "end_ns": end,
                       "self_ns": end - self.start - self.child_ns})
        return False


class Recorder:
    """Spans and counters of one process, kept in memory until ``drain()``.

    A span records its name, start and end, the id of its parent (the
    innermost span open on the same thread), the id of its call (the
    outermost one open there, an engine call on the serving path), the
    thread and its self time (duration less its children's).  Counters
    are summed."""

    def __init__(self):
        self.on = False
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._spans: List[Dict] = []
        self._counters: Dict[str, int] = {}

    def clock_ns(self) -> int:
        """Now, on the spans' clock (Unix-epoch ns)."""
        return time.perf_counter_ns() + self._offset_ns

    def enable(self) -> None:
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str):
        """``with span("engine.plan"): ...``"""
        if not self.on:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def drain(self) -> Dict:
        """→ {"spans": [...], "counters": {...}}, and forget them."""
        with self._lock:
            out = {"spans": self._spans, "counters": self._counters}
            self._spans, self._counters = [], {}
        return out

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, record: Dict) -> None:
        with self._lock:
            self._spans.append(record)


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
enable = _RECORDER.enable
disable = _RECORDER.disable
drain = _RECORDER.drain
clock_ns = _RECORDER.clock_ns
