"""Each per-layer reader on a record: its value where the record has what it
reads, nothing where it has not; readers are found by full or base name."""

import json

import pytest
from conftest import BENCH, ROOT

import run

TRACE = {"window_s": 10.0, "busy_s": 4.0, "audio_s": 2000.0, "model_flops": 1.0e15,
         "layers": {"prior": 0.2, "flow": 0.05, "vocoder": 1.0, "engine": 0.1},
         "kernels": {"attn": 0.1, "wn": 0.2, "mrf": 2.0},
         "bounds": {"attn": 0.01, "wn": 0.02, "mrf": 0.5},
         "frames_real": 900, "frames_padded": 1000}
RECORD = {"trace": TRACE}
EXPECT = {"frame_fill_pct": 90.0,
          "prior_ms_per_audio_s": 0.1, "flow_ms_per_audio_s": 0.025,
          "vocoder_ms_per_audio_s": 0.5, "attn_roofline": 10.0, "wn_roofline": 10.0,
          "mrf_roofline": 25.0, "device_idle_pct": 60.0,
          "mfu_pct": 100.0 * 1.0e15 / (10.0 * 989e12)}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_reads_its_value_or_nothing(name):
    mod = run.load_module(BENCH / "metrics" / f"{name}.py", f"m_{name}")
    assert mod.read(RECORD) == pytest.approx(EXPECT[name])
    assert mod.read({"trace": None}) is None


def test_every_reader_file_has_an_expectation():
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == set(EXPECT)


def test_metrics_are_found_by_full_then_base_name():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = run.read_metrics(spec["per_layer"], RECORD)
    assert set(out) == {m["name"] for m in spec["per_layer"]}
    assert all(set(v) == {"value", "unit"} for v in out.values())
