"""``BENCHMARK.json`` against the benchmark's contract: keys, the character
rules for names and units, the files each entry needs, the budget."""

import json
import re

import pytest
from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$"
                   r"|experts_per_tok|channels|filter)")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("kind,entries", [("config", SPEC["configs"]),
                                          ("workload", SPEC["workloads"]),
                                          ("end_to_end", SPEC["end_to_end"]),
                                          ("per_layer", SPEC["per_layer"])])
def test_entries_have_just_their_keys_and_good_names(kind, entries):
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key])


def test_configs_files_and_reductions():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert (ROOT / c["file"]).is_file() and _line(c["source"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "references" / f"{cfg['reference']}.py").is_file()


def test_workloads_have_their_files_and_one_chip():
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        check = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert set(check["limits"]) == {"dur_gap", "f0_err", "energy_err", "pcm_err"}


def test_metrics_reach_every_cell():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        layer = [m for m in SPEC["per_layer"] if cell in m.get("workloads", cells)]
        assert layer
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in moved.get("workloads", cells)
        reader = BENCH / "metrics" / f"{m['name']}.py"
        assert reader.is_file() or (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_shares_are_named_for_what_they_bound():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_run_seconds_fit_the_check_budget():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_by_the_rules():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            assert PATH.match(str(f.relative_to(ROOT))), f
