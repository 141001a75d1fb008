"""The traffic generator: deterministic by seed, within its stated lengths,
the same amounts of work for every seed."""

import json

import pytest
from conftest import BENCH

import traffic

CFG = json.loads((BENCH / "configs" / "vispeech-44k.json").read_text())
MIXES = {p.stem: json.loads(p.read_text()) for p in (BENCH / "traffic").glob("*.json")}
SEEDS = (0, 7, 2**31 + 11)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_is_deterministic_by_seed(name):
    mix = MIXES[name]
    a, b = traffic.batch_call(mix, CFG, 5, 3), traffic.batch_call(mix, CFG, 5, 3)
    c = traffic.batch_call(mix, CFG, 6, 3)
    assert a == b
    assert a != c


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_stays_within_its_lengths(name, seed):
    mix = MIXES[name]
    counts = traffic.length_range(mix, CFG["weights"]["ms_per_token"])
    reqs = traffic.batch_call(mix, CFG, seed, 0)
    assert len(reqs) == mix["call_size"]
    assert len({r.speaker for r in reqs}) == 1
    symbols = set(CFG["symbols"][1:])
    for r in reqs:
        assert counts.start <= len(r.phones) < counts.stop
        assert set(r.phones) <= symbols
        assert 0 <= r.speaker < CFG["data"]["n_speakers"]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_gets_the_same_work(name):
    mix = MIXES[name]
    sizes = [sorted(len(r.phones) for r in traffic.batch_call(mix, CFG, s, 0)) for s in SEEDS]
    assert all(s == sizes[0] for s in sizes)


@pytest.mark.parametrize("spec, mean, median", [
    ({"dist": "lognormal", "median": 6.0, "sigma": 0.45, "min": 1.5, "max": 16.25}, None, 6.0),
    ({"dist": "uniform", "min": 1.0, "max": 3.0}, 2.0, 2.0),
    # LJSpeech's min, mean, max: mode 8.50, median a + sqrt((b - a)(c - a) / 2)
    ({"dist": "triangular", "min": 1.11, "mean": 6.57, "max": 10.10}, 6.57,
     1.11 + (8.99 * 7.39 / 2) ** 0.5),
])
def test_quantiles_follow_the_distribution(spec, mean, median):
    qs = traffic._quantiles(spec, 256)
    assert qs == sorted(qs)
    assert min(qs) >= spec["min"] and max(qs) <= spec["max"]
    assert qs[127] < median < qs[128]
    if mean is not None:
        assert sum(qs) / len(qs) == pytest.approx(mean, abs=0.01)


def test_triangular_needs_a_mean_inside_its_range():
    with pytest.raises(ValueError):
        traffic._quantiles({"dist": "triangular", "min": 1.0, "mean": 9.0, "max": 10.0}, 8)
