"""The port's request coalescer (``vispeech_tpu_torch/infer/coalescer.py``)
and the engine's one-call-at-a-time lock, on the CPU.

Every case of ``tests/test_coalescer.py`` against a fake engine (grouping,
fallbacks, errors, backpressure), and the three faults that the JAX
coalescer has, each against the repair:

* one oversized request failed its whole coalesced group: now it fails
  alone, and a group whose ``synthesize_batch`` raises is retried request
  by request;
* a request's fixed seed was not reproducible under coalescing, since
  ``synthesize_batch`` draws every plan's noise from one generator in plan
  order: a request that names its seed is now synthesized alone, so its
  audio equals the engine's direct call whatever arrives with it;
* ``close()`` left queued callers waiting for their 300 s timeout: now it
  answers them with ``ServerBusy`` at once.

The seed, size and lock cases run a real engine at the small widths of
``test_torch_synthesizer.py``, with weights drawn from a seed (the duration
head biased to about e^1.6 − 1 ≈ 4 frames a phoneme).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.infer.coalescer import RequestCoalescer, ServerBusy
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.text import N_SYMBOLS

CFG = {
    "train": {"segment_size": 16, "fp16_run": False},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 4,
             "win_length": 16, "n_speakers": 4},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "upsample_rates": [2, 2],
              "upsample_initial_channel": 128, "upsample_kernel_sizes": [4, 4],
              "gin_channels": 8},
}
SHORT = ["[P]ni2 hao3[P]", "[P]zai4 jian4[P]", "[P]xie4 xie4[P]"]
LONG = "[P]" + " ".join(["wo3 men5 zou3 ba5 hao3 de5 tian1 qi4"] * 3) + "[P]"


class FakeEngine:
    """Records call shapes; returns per-request dicts like TTSEngine."""

    max_phonemes = 8

    def __init__(self, delay=0.0, fail_batch=False, fail_single=False, gate=None):
        self.batch_calls, self.single_calls = [], []
        self.delay, self.fail_batch, self.fail_single = delay, fail_batch, fail_single
        self.gate = gate                 # an Event synthesize waits on
        self.entered = threading.Event()
        self.lock = threading.Lock()

    def _result(self, phones):
        return {"audio": np.zeros(8, np.float32), "sampling_rate": 8000,
                "phones": list(phones), "duration": np.ones(len(phones)),
                "f0": np.full(len(phones), 200.0), "energy": np.full(len(phones), 60.0)}

    def synthesize_batch(self, phones_list, speakers, noise_scale):
        if self.fail_batch:
            raise RuntimeError("batch on fire")
        time.sleep(self.delay)
        with self.lock:
            self.batch_calls.append((len(phones_list), tuple(speakers), noise_scale))
        return [self._result(p) for p in phones_list]

    def synthesize(self, phones, **kwargs):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(10)
        if self.fail_single:
            raise RuntimeError("device on fire")
        time.sleep(self.delay)
        with self.lock:
            self.single_calls.append((tuple(phones), dict(kwargs)))
        return self._result(phones)


def submit_many(c, requests):
    """Submit concurrently; returns (results, errors) in request order."""
    results, errors = [None] * len(requests), [None] * len(requests)

    def worker(i, phones, kwargs):
        try:
            results[i] = c.submit(phones, **kwargs)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, p, kw), daemon=True)
               for i, (p, kw) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return results, errors


@pytest.mark.parametrize("requests,batch_calls,singles", [
    # co-arrivals ride one synthesize_batch call, speaker order kept
    ([(["n", "i2"], {"speaker": i}) for i in range(4)], [(4, (0, 1, 2, 3), 0.667)], []),
    # per-phoneme overrides (a prosody edit) fall back to synthesize
    ([(["a"], {}), (["b"], {"pitch_control": np.array([220.0])}), (["c"], {})],
     [(2, (0, 0), 0.667)], [("b",)]),
    # distinct noise scales never mix; a lone group member runs alone
    ([(["a"], {"noise_scale": 0.5}), (["b"], {"noise_scale": 0.5}),
      (["c"], {"noise_scale": 0.9})], [(2, (0, 0), 0.5)], [("c",)]),
    # a request that names its seed runs alone, even seed 0 (the default)
    ([(["a"], {}), (["b"], {"seed": 0}), (["c"], {}), (["d"], {"seed": 5})],
     [(2, (0, 0), 0.667)], [("b",), ("d",)]),
    # a single request pays no batch planning
    ([(["n", "i2"], {})], [], [("n", "i2")]),
])
def test_routing(requests, batch_calls, singles):
    eng = FakeEngine()
    c = RequestCoalescer(eng, window_ms=150, max_batch=8)
    try:
        results, errors = submit_many(c, requests)
        assert errors == [None] * len(requests)
        assert [r["phones"] for r in results] == [list(p) for p, _ in requests]
        assert eng.batch_calls == batch_calls
        assert sorted(p for p, _ in eng.single_calls) == singles
        assert c.batch_sizes == [n for n, _, _ in batch_calls]
    finally:
        c.close()


@pytest.mark.parametrize("fail_batch,fail_single", [(True, True), (True, False),
                                                     (False, True)])
def test_engine_errors(fail_batch, fail_single):
    """An engine error reaches the caller; a group whose synthesize_batch
    raises is retried request by request, so only a request that fails
    alone gets an error."""
    eng = FakeEngine(fail_batch=fail_batch, fail_single=fail_single)
    c = RequestCoalescer(eng, window_ms=100, max_batch=8)
    try:
        reqs = [(["a"], {}), (["b"], {}), (["c"], {"pitch_control": [200.0]})]
        results, errors = submit_many(c, reqs)
        batch_ok = not fail_batch
        expect_ok = [batch_ok or not fail_single] * 2 + [not fail_single]
        assert [e is None for e in errors] == expect_ok
        assert all(isinstance(e, RuntimeError) for e in errors if e is not None)
        assert [r is not None for r in results] == expect_ok
        assert c.batch_sizes == ([2] if batch_ok else [])
    finally:
        c.close()


def test_queue_full_raises_server_busy():
    eng = FakeEngine(delay=0.2)
    c = RequestCoalescer(eng, window_ms=1, max_batch=1, max_queue=2)
    try:
        results, errors = submit_many(c, [(["x"], {}) for _ in range(8)])
        busy = [e for e in errors if isinstance(e, ServerBusy)]
        ok = [r for r in results if r is not None]
        assert busy, "expected at least one 503-style rejection"
        assert ok, "expected at least one success"
        assert len(busy) + len(ok) == 8
    finally:
        c.close()


def test_oversized_request_fails_alone():
    """A request over ``max_phonemes`` among good ones: it alone gets an
    error, and the good ones still ride one batch."""
    eng = FakeEngine()
    c = RequestCoalescer(eng, window_ms=150, max_batch=8)
    try:
        reqs = [(["a"], {}), (["x"] * 9, {}), (["b"], {}), (["c"], {})]
        results, errors = submit_many(c, reqs)
        assert isinstance(errors[1], ValueError) and "too many phonemes" in str(errors[1])
        assert results[1] is None
        assert [e is None for e in errors] == [True, False, True, True]
        assert eng.batch_calls == [(3, (0, 0, 0), 0.667)]
    finally:
        c.close()


def test_close_answers_queued_callers():
    """``close()`` answers every queued request with ServerBusy at once (not
    at the 300 s timeout), lets the request on the engine finish, and
    refuses new ones."""
    gate = threading.Event()
    eng = FakeEngine(gate=gate)
    c = RequestCoalescer(eng, window_ms=1, max_batch=1)
    outcomes = {}

    def client(i):
        try:
            outcomes[i] = c.submit(["p"])
        except Exception as e:  # noqa: BLE001
            outcomes[i] = e

    first = threading.Thread(target=client, args=(0,), daemon=True)
    first.start()
    assert eng.entered.wait(5)
    queued = [threading.Thread(target=client, args=(i,), daemon=True) for i in (1, 2)]
    for t in queued:
        t.start()
    deadline = time.monotonic() + 5
    while c.q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c.q.qsize() == 2
    t0 = time.monotonic()
    c.close(join_timeout=0.1)
    for t in queued:
        t.join(timeout=2)
        assert not t.is_alive()
    assert time.monotonic() - t0 < 2
    assert all(isinstance(outcomes[i], ServerBusy) for i in (1, 2))
    gate.set()
    first.join(timeout=5)
    assert outcomes[0]["phones"] == ["p"]
    c.thread.join(timeout=2)
    assert not c.thread.is_alive()
    with pytest.raises(ServerBusy, match="shutting down"):
        c.submit(["q"])


# ------------------------------------------------------ with a real engine

@pytest.fixture(scope="module")
def engine():
    model = random_init_(Synthesizer.from_config(config_from_dict(CFG), N_SYMBOLS), seed=11)
    with torch.no_grad():
        model.duration_predictor.proj.weight.mul_(0.1)
        model.duration_predictor.proj.bias.fill_(1.6)
    return TTSEngine(config_from_dict(CFG), model.state_dict(), device="cpu",
                     max_phonemes=64)


@pytest.mark.parametrize("seed,others", [(0, [{}, {}, {}]),
                                         (5, [{"seed": 5}, {}, {}])])
def test_seeded_request_is_reproducible(engine, seed, others):
    """A request that names its seed gives the same audio alone and amid
    concurrent requests: the engine's direct ``synthesize(seed=…)``.  It is
    the longest request, so in a batch its plan would come last and draw
    other noise."""
    phones = engine.phonemes(LONG)
    direct = engine.synthesize(phones=phones, seed=seed)["audio"]
    c = RequestCoalescer(engine, window_ms=200, max_batch=8)
    try:
        alone = c.submit(phones, seed=seed)["audio"]
        reqs = [(engine.phonemes(t), kw) for t, kw in zip(SHORT, others)]
        results, errors = submit_many(c, reqs + [(phones, {"seed": seed})])
        assert errors == [None] * 4
        assert c.batch_sizes and max(c.batch_sizes) >= 2
        for (p, kw), res in zip(reqs, results):
            if "seed" in kw:
                np.testing.assert_array_equal(
                    res["audio"], engine.synthesize(phones=p, seed=kw["seed"])["audio"])
    finally:
        c.close()
    assert np.abs(direct).max() > 0
    np.testing.assert_array_equal(alone, direct)
    np.testing.assert_array_equal(results[-1]["audio"], direct)


def test_oversized_request_fails_alone_on_the_engine(engine):
    """With the real engine: 3 good requests answered in one batch, the
    request over ``max_phonemes`` (64) answered with the engine's error."""
    long_phones = engine.phonemes(LONG) * 2
    assert len(long_phones) > engine.max_phonemes
    c = RequestCoalescer(engine, window_ms=200, max_batch=8)
    try:
        reqs = [(engine.phonemes(t), {}) for t in SHORT]
        results, errors = submit_many(c, reqs[:2] + [(long_phones, {})] + reqs[2:])
        assert [e is None for e in errors] == [True, True, False, True]
        assert "too many phonemes" in str(errors[2])
        assert c.batch_sizes == [3]
        for (p, _), res in zip(reqs, results[:2] + results[3:]):
            assert res["phones"] == p and len(res["audio"]) > 0
    finally:
        c.close()


def test_engine_calls_never_overlap(engine, monkeypatch):
    """Four engine calls from four threads (synthesize twice,
    synthesize_batch, voice_conversion) run one at a time."""
    active, peak, guard = [0], [0], threading.Lock()

    def tracked(fn):
        def run(*args, **kwargs):
            with guard:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            try:
                time.sleep(0.05)
                return fn(*args, **kwargs)
            finally:
                with guard:
                    active[0] -= 1
        return run

    for name in ("infer", "voice_conversion"):
        monkeypatch.setattr(engine.model, name, tracked(getattr(engine.model, name)))
    calls = [lambda: engine.synthesize(text=SHORT[0]),
             lambda: engine.synthesize(text=SHORT[1], seed=2),
             lambda: engine.synthesize_batch(texts=SHORT),
             lambda: engine.voice_conversion(np.zeros(160, np.float32), 1, 2)]
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(fn,), daemon=True) for fn in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert peak[0] == 1
