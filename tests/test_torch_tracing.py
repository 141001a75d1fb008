"""The program's span and counter recorder (``utils/profiling.py``) on the
serving path, at a tiny configuration on the CPU: off it records nothing and
changes no output; on, one ``synthesize_batch`` gives one ``engine.call``,
an ``engine.durations`` a phoneme-padding group, an ``engine.plan`` a
(bucket, tier) plan with its staging, the model's layers and mode switches
inside, and an ``engine.fetch`` and ``engine.assemble`` a plan beside it,
plan k's opening after plan k + 1 was issued (the depth-1 pipeline), and
counters that match the plans; spans nest by thread."""

import threading

import numpy as np
import pytest
import torch

from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.infer.batching import pick_bucket, plan_batches
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.utils import profiling

HOP = 4
CFG = {
    "train": {"segment_size": 4 * HOP, "fp16_run": False},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": HOP,
             "win_length": 16, "n_speakers": 4, "spk2id": {"alice": 1, "bob": 2}},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "upsample_rates": [2, 2],
              "upsample_initial_channel": 128, "upsample_kernel_sizes": [4, 4],
              "gin_channels": 8},
}
# two phoneme paddings (32 and 64); tiers 4 + 2 + 1 at one bucket
TEXTS = (["[P]ni2 hao3 shi4 jie4[P]", "[P]zai4 jian4[P]", "[P]wo3 men5 zou3 ba5 hao3 de5[P]"] * 2
         + ["[P]" + " ".join(["ni2 hao3"] * 12) + "[P]"])
PLAN_CHILDREN = ["engine.stage", "prior", "flow", "vocoder"]
# ``infer``, ``infer_prior`` and ``infer_decode`` each switch to eval mode and back
PLAN_MODES = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    cfg = config_from_dict(CFG)
    model = random_init_(Synthesizer.from_config(cfg, N_SYMBOLS), 3)
    return TTSEngine(cfg, model.state_dict(), device="cpu", transfer_int16=True)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _recorded(fn):
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()


def _batch(engine):
    return engine.synthesize_batch(texts=TEXTS, seed=1)


def _plans(out):
    return plan_batches([max(int(r["duration"].sum()), 1) for r in out])


def _children(spans, parent):
    """Names of ``parent``'s child spans, in the order they opened."""
    return [c["name"] for c in sorted(spans, key=lambda c: c["start_ns"])
            if c["parent"] == parent["id"]]


def _groups(out):
    return {-(-len(r["phones"]) // 32) for r in out}


def test_off_records_nothing_and_changes_no_output(engine):
    off = _batch(engine)
    assert profiling.drain() == {"spans": [], "counters": {}}
    on, got = _recorded(lambda: _batch(engine))
    assert got["spans"]
    for a, b in zip(off, on):
        assert np.array_equal(a["audio_int16"], b["audio_int16"])
        assert np.array_equal(a["duration"], b["duration"])


def test_off_span_is_one_shared_context():
    assert profiling.span("a") is profiling.span("b")
    profiling.count("plans", 3)
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_batch_call_spans(engine):
    out, got = _recorded(lambda: _batch(engine))
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    calls = [s for s in spans if s["name"] == "engine.call"]
    assert len(calls) == 1
    call = calls[0]
    plans = _plans(out)
    assert call["parent"] is None
    assert all(s["call"] == call["id"] for s in spans)
    assert len({s["thread"] for s in spans}) == 1
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and 0 <= s["self_ns"] <= s["end_ns"] - s["start_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]

    durations = [s for s in spans if s["name"] == "engine.durations"]
    assert len(durations) == len(_groups(out)) == 2
    for d in durations:
        assert d["parent"] == call["id"]
        assert _children(spans, d) == ["modes", "prior", "modes"]

    plan_spans = [s for s in spans if s["name"] == "engine.plan"]
    assert len(plan_spans) == len(plans)
    for s in plan_spans:
        assert s["parent"] == call["id"]
        children = _children(spans, s)
        assert [c for c in children if c != "modes"] == PLAN_CHILDREN
        assert children.count("modes") == PLAN_MODES
        child_ns = sum(c["end_ns"] - c["start_ns"] for c in spans if c["parent"] == s["id"])
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - child_ns

    # one fetch and one assemble a plan, under the call, each fetch right
    # before its assemble; plan k's fetch opens after plan k + 1's prior
    fetches = sorted((s for s in spans if s["name"] == "engine.fetch"),
                     key=lambda s: s["start_ns"])
    assembles = sorted((s for s in spans if s["name"] == "engine.assemble"),
                       key=lambda s: s["start_ns"])
    assert len(fetches) == len(assembles) == len(plans) > 1
    assert all(s["parent"] == call["id"] for s in fetches + assembles)
    for f, a in zip(fetches, assembles):
        assert f["end_ns"] <= a["start_ns"]
    plan_spans.sort(key=lambda s: s["start_ns"])
    priors = [next(c for c in spans if c["parent"] == p["id"] and c["name"] == "prior")
              for p in plan_spans]
    for k, f in enumerate(fetches[:-1]):
        assert priors[k + 1]["start_ns"] < f["start_ns"]
        assert plan_spans[k + 1]["end_ns"] <= f["start_ns"]
    assert plan_spans[-1]["end_ns"] <= fetches[-1]["start_ns"]


def test_counters_match_the_plans(engine):
    out, got = _recorded(lambda: _batch(engine))
    plans = _plans(out)
    assert got["counters"] == {
        "plans": len(plans),
        "frames_padded": sum(p.tier * p.bucket for p in plans),
        # one wait a plan, on its copies' event, and one a duration pass
        "syncs": len(plans) + len(_groups(out)),
        # every plan but the last is fetched with the next one issued
        "plans_overlapped": len(plans) - 1,
    }


def test_synthesize_is_one_call(engine):
    out, got = _recorded(lambda: engine.synthesize(text=TEXTS[0], seed=1))
    names = [s["name"] for s in got["spans"]]
    assert names.count("engine.call") == 1 and names.count("engine.plan") == 1
    assert got["counters"]["plans"] == 1
    assert got["counters"]["frames_padded"] == pick_bucket(int(out["duration"].sum()))
    # the duration pass, the frame count, the PCM and three per-phoneme arrays
    assert got["counters"]["syncs"] == 6
    assert len(out["audio_int16"]) == int(out["duration"].sum()) * HOP


def test_voice_conversion_is_one_call(engine):
    wav = np.sin(np.arange(24 * HOP, dtype=np.float32))
    _, got = _recorded(lambda: engine.voice_conversion(wav, 1, 2))
    names = [s["name"] for s in got["spans"]]
    assert names.count("engine.call") == 1
    assert {"engine.stage", "vocoder", "engine.fetch"} <= set(names)
    assert got["counters"] == {"syncs": 1}


def test_drain_clears():
    profiling.enable()
    with profiling.span("a"):
        profiling.count("plans", 2)
    got = profiling.drain()
    assert [s["name"] for s in got["spans"]] == ["a"] and got["counters"] == {"plans": 2}
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_span_on_another_thread_has_no_parent_here():
    def inner():
        with profiling.span("inner"):
            pass

    profiling.enable()
    with profiling.span("outer") as outer:
        t = threading.Thread(target=inner)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("child"):
            pass
    spans = {s["name"]: s for s in profiling.drain()["spans"]}
    inner = spans["inner"]
    assert inner["parent"] is None and inner["call"] == inner["id"]
    assert inner["thread"] != spans["outer"]["thread"]
    assert spans["child"]["parent"] == spans["child"]["call"] == outer.id
