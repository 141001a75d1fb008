"""A whole run on the CPU at the tiny size: the result's keys,
``correct`` on the sound program and false under each fault the cells can
have; no card, no result."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import BULK, ROOT, loaded_cell

import check
import run

SEED = 2**31 + 101
KEYS = ["correct", "attempted", "failed", "metrics"]


def _run(cfg, mix, hook=None):
    torch.manual_seed(0)
    return run.run_cell(loaded_cell(cfg, mix), SEED, 0.6, False, "cpu", engine_hook=hook)


def test_sound_run_is_correct_and_has_the_result_keys(tiny):
    res = _run(tiny, BULK)
    assert list(res)[:4] == KEYS and list(res)[-1] == "checked"
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checked"]) == set(check.NUMBERS)
    assert all(set(v) == {"value", "limit"} for v in res["checked"].values())
    assert set(res["metrics"]) == {"setup_s", "audio_s_per_s"}


def _altered_duration(engine):
    """A token altered where it is produced: one phoneme of the first row of
    every duration pass is a frame longer."""
    predict = engine._predicted_durations

    def altered(*args):
        out = predict(*args)
        out[0, 0] += 1.0
        return out
    engine._predicted_durations = altered


def _half_left_out(engine):
    """Half of each plan's rows left out: their audio is silence."""
    infer = engine.model.infer

    def halved(*args, **kw):
        out = infer(*args, **kw)
        audio = out[0].clone()
        audio[audio.shape[0] // 2:] = 0.0
        return (audio, *out[1:])
    engine.model.infer = halved


def _answer_altered(engine):
    """An answer altered where it is produced: the fetched PCM's sign."""
    fetch = engine._fetch_audio

    def flipped(audio):
        return fetch(-audio)
    engine._fetch_audio = flipped


def _window_call_raises(engine):
    """A call that fails: its requests are never served or checked."""
    synthesize_batch = engine.synthesize_batch
    calls = []

    def failing(*args, **kw):
        calls.append(None)
        if len(calls) == 2:        # the warm-up's call, then the window's first
            raise RuntimeError("planted failure")
        return synthesize_batch(*args, **kw)
    engine.synthesize_batch = failing


@pytest.mark.parametrize("fault", [_altered_duration, _half_left_out, _answer_altered])
def test_each_fault_makes_the_run_incorrect(tiny, fault):
    res = _run(tiny, BULK, fault)
    assert not res["correct"], res["checked"]


def test_a_failed_call_makes_the_run_incorrect(tiny):
    res = _run(tiny, BULK, _window_call_raises)
    assert res["failed"] == BULK["call_size"] and not res["correct"]


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "v44k-bulk-longform",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    for p in ("BENCHMARK.json",):
        (tmp_path / p).write_text((ROOT / p).read_text())
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(tmp_path / "portbench")], check=True)
    proc = subprocess.run([sys.executable, "-c",
                           "import sys; sys.argv = ['run.py', '--workload', 'v44k-bulk-longform',"
                           " '--seed', '1', '--seconds', '1']; sys.path.insert(0, 'portbench');"
                           " import run; run.load_cell(run.ROOT, 'v44k-bulk-longform');"
                           " import vispeech_tpu_torch"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""

