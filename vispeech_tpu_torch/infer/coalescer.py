"""Request coalescing for the HTTP server (``vispeech_tpu/infer/coalescer.py``).

Handler threads ``submit()`` and block on a per-request event; a single
dispatcher thread drains the queue, waits up to ``window_ms`` for
co-arriving requests (bounded by ``max_batch``), then

* checks each request's phoneme count against ``engine.max_phonemes``: an
  oversized request gets its error alone and never joins a group;
* runs requests with predictor-driven prosody, no explicit ``seed`` and the
  same ``noise_scale`` as ONE ``TTSEngine.synthesize_batch`` call, whose
  bucket planner (``infer/batching.py``) turns them into few padded
  dispatches.  If that call raises, each member is retried alone through
  ``synthesize``, so only a faulty request gets an error;
* runs every other request alone through ``synthesize`` within the same
  drain: per-phoneme overrides (the prosody-edit loop), a lone request, and
  a request with an explicit ``seed``.

Seeds: ``synthesize_batch`` draws every plan's prior noise from one
generator in plan order, so a request's noise there depends on what
arrived with it.  A request that names its seed is therefore never
batched: its audio equals ``engine.synthesize(..., seed=s)`` whatever
arrives beside it.  Requests without a seed coalesce and take the
engine's default.

Backpressure: a bounded queue; when it is full ``submit`` raises
:class:`ServerBusy`, which the HTTP layer answers with 503.  ``close()``
refuses new requests, answers every queued one with ``ServerBusy`` and
joins the dispatcher briefly.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_OVERRIDES = ("duration_control", "pitch_control", "energy_control")


class ServerBusy(RuntimeError):
    """Queue full or server shutting down: translate to HTTP 503."""


@dataclass
class _Pending:
    phones: list
    kwargs: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[BaseException] = None


def _batchable(kwargs: Dict[str, Any]) -> bool:
    """Predictor-driven prosody (the ``synthesize_batch`` contract) and no
    explicit seed."""
    return "seed" not in kwargs and all(kwargs.get(k) is None for k in _OVERRIDES)


class RequestCoalescer:
    def __init__(self, engine, window_ms: float = 20.0, max_batch: int = 16,
                 max_queue: int = 256):
        self.engine = engine
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.q: "queue.Queue[Optional[_Pending]]" = queue.Queue(maxsize=max_queue)
        #: the size of every ``synthesize_batch`` group that succeeded
        self.batch_sizes: List[int] = []
        self._stop = False
        self._closing = threading.Lock()   # orders submit's put against close's drain
        self.thread = threading.Thread(target=self._run, name="coalescer", daemon=True)
        self.thread.start()

    def close(self, join_timeout: float = 1.0) -> None:
        """Stop the dispatcher: refuse new requests, answer every queued one
        with ``ServerBusy``, and join the dispatcher for at most
        ``join_timeout`` seconds (a group on the device finishes on its own)."""
        with self._closing:
            if self._stop:
                return
            self._stop = True
        while True:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            item.error = ServerBusy("server shutting down")
            item.done.set()
        self.q.put_nowait(None)   # wakes the dispatcher (the queue is empty, and stays so)
        self.thread.join(join_timeout)

    # ------------------------------------------------------------- client
    def submit(self, phones: list, timeout: float = 300.0, **kwargs) -> dict:
        """Blocking: returns the synthesize() result dict or re-raises the
        engine's exception in the caller's thread."""
        item = _Pending(phones=list(phones), kwargs=kwargs)
        with self._closing:
            if self._stop:
                raise ServerBusy("server shutting down")
            try:
                self.q.put_nowait(item)
            except queue.Full:
                raise ServerBusy(
                    f"request queue full ({self.q.maxsize} pending)") from None
        if not item.done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if item.error is not None:
            raise item.error
        return item.result

    # --------------------------------------------------------- dispatcher
    def _drain_window(self) -> List[_Pending]:
        """The requests of one window; ``close()``'s None ends it early."""
        try:
            first = self.q.get(timeout=0.25)
        except queue.Empty:
            return []
        batch = [first] if first is not None else []
        deadline = time.monotonic() + self.window_s
        while batch and len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while not self._stop:
            batch = self._drain_window()
            if batch:
                self._process(batch)

    def _process(self, batch: List[_Pending]) -> None:
        groups: Dict[float, List[_Pending]] = {}
        singles: List[_Pending] = []
        for item in batch:
            if len(item.phones) > self.engine.max_phonemes:
                item.error = ValueError(
                    f"too many phonemes: {len(item.phones)} > {self.engine.max_phonemes}")
                item.done.set()
            elif _batchable(item.kwargs):
                groups.setdefault(float(item.kwargs.get("noise_scale", 0.667)), []).append(item)
            else:
                singles.append(item)

        for noise_scale, items in groups.items():
            if len(items) == 1:
                singles.extend(items)
                continue
            try:
                results = self.engine.synthesize_batch(
                    phones_list=[it.phones for it in items],
                    speakers=[it.kwargs.get("speaker", 0) for it in items],
                    noise_scale=noise_scale)
            except Exception:  # noqa: BLE001 - each member is retried alone below
                singles.extend(items)
                continue
            self.batch_sizes.append(len(items))
            for it, res in zip(items, results):
                it.result = res
                it.done.set()

        for it in singles:
            try:
                it.result = self.engine.synthesize(phones=it.phones, **it.kwargs)
            except Exception as e:  # noqa: BLE001 - delivered to the caller
                it.error = e
            finally:
                it.done.set()
