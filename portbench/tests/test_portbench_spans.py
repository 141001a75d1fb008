"""``spans.py`` on a synthetic trace: idle stretches split at span
boundaries, time under no span counted outside, the parts summing to the
idle ``tracing.device_trace`` computes; the clock checks and the per-layer
numbers; ``span_trace.py``'s recorder cost."""

from types import SimpleNamespace

import pytest
import torch

import spans
import tracing

BASE = 1_700_000_000_000_000_000      # ns: the profiler's epoch clock
MS = 1_000_000


def _ns(ms):
    return BASE + int(ms * MS)


def _s(ms):
    return _ns(ms) * 1e-9


def _span(i, name, a, b, parent=None, thread=1, self_ms=None):
    return {"id": i, "parent": parent, "call": 1, "thread": thread, "name": name,
            "start_ns": _ns(a), "end_ns": _ns(b),
            "self_ns": int(((b - a) if self_ms is None else self_ms) * MS)}


# one engine call: a duration group, then one plan (ms)
SPANS = [
    _span(1, "engine.call", 0, 100, self_ms=14),
    _span(2, "engine.durations", 2, 20, 1, self_ms=6),
    _span(3, "prior", 3, 15, 2),
    _span(4, "engine.plan", 22, 90, 1, self_ms=2),
    _span(5, "engine.stage", 22, 25, 4),
    _span(6, "prior", 25, 50, 4),
    _span(7, "flow", 50, 55, 4),
    _span(8, "vocoder", 55, 60, 4),
    _span(9, "engine.fetch", 60, 85, 4),
    _span(10, "engine.assemble", 86, 89, 4),
]
# (start ms, end ms, name): work, a copy a blocking span waits on, markers
OPS = [(4, 16, "conv"), (15, 16, "Memcpy DtoH"), (3.5, 3.5005, tracing.MARKER),
       (26, 52, "gemm"), (27, 27.0005, tracing.MARKER), (53, 84, "mrf"),
       (80, 81, "Memcpy DtoH"), (81, 82, "Memcpy DtoH"), (82, 83, "Memcpy DtoH"),
       (83, 84, "Memcpy DtoH")]
LABELS = ["prior", "prior"]
DRAINED = {"spans": SPANS, "counters": {"plans": 1, "syncs": 5, "frames_padded": 640}}


def _ops():
    return sorted((_s(a), _s(b), n) for a, b, n in OPS)


class _Event:
    def __init__(self, a, b, name):
        self.a, self.b, self.n = _ns(a), _ns(b), name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def name(self):
        return self.n


def _prof():
    events = [_Event(*op) for op in OPS]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_host_timeline_takes_the_innermost_span():
    pieces = [(round((a - _s(0)) * 1e3, 3), round((b - _s(0)) * 1e3, 3), n)
              for a, b, n in spans.host_timeline(SPANS)]
    assert pieces == [(0, 2, "engine.call"), (2, 3, "engine.durations"), (3, 15, "prior"),
                      (15, 20, "engine.durations"), (20, 22, "engine.call"),
                      (22, 25, "engine.stage"), (25, 50, "prior"), (50, 55, "flow"),
                      (55, 60, "vocoder"), (60, 85, "engine.fetch"), (85, 86, "engine.plan"),
                      (86, 89, "engine.assemble"), (89, 90, "engine.plan"),
                      (90, 100, "engine.call")]


def test_gaps_are_split_at_span_boundaries():
    idle = spans.idle_intervals(_ops(), _s(16), _s(26))
    got = spans.split_idle(idle, spans.host_timeline(SPANS))
    assert {k: round(v * 1e3, 3) for k, v in got.items() if v} == {
        "engine.durations": 4, "engine.call": 2, "engine.stage": 3, "prior": 1}


def test_time_under_no_span_is_outside():
    idle = spans.idle_intervals(_ops(), _s(-10), _s(110))
    got = spans.split_idle(idle, spans.host_timeline(SPANS))
    assert got[spans.OUTSIDE] == pytest.approx(0.020, abs=1e-6)
    assert got["engine.call"] == pytest.approx(0.014, abs=1e-6)
    assert "vocoder" not in got


def test_parts_sum_to_device_trace_idle():
    t0, t1 = _s(-10), _s(110)
    t = tracing.device_trace(_prof(), LABELS, t1 - t0)
    out = spans.reduce(_ops(), LABELS, DRAINED, t0, t1, dict(t, audio_s=2.0))
    assert sum(out["idle_pct"].values()) == pytest.approx(100.0 * (1 - t["busy_s"] / (t1 - t0)),
                                                         abs=1e-3)
    assert out["idle_pct"] == pytest.approx({"prior": 100 * 2 / 120, "flow": 100 * 1 / 120,
                                             "vocoder": 0.0, "engine": 100 * 28 / 120,
                                             "outside": 100 * 20 / 120}, abs=1e-3)
    # between the first and the last operation: device_trace's gaps alone
    inner = spans.reduce(_ops(), LABELS, DRAINED, _s(4), _s(84), dict(t, audio_s=2.0))
    assert inner["idle_s"] == pytest.approx(sum(v for _, v in t["idle_gaps"]), abs=1e-6)
    assert sum(inner["idle_by_span_s"].values()) == pytest.approx(inner["idle_s"], abs=1e-6)


def test_metrics_and_clock_checks():
    out = spans.reduce(_ops(), LABELS, DRAINED, _s(-10), _s(110), {"audio_s": 2.0})
    m = out["metrics"]
    assert set(m) == set(spans.METRICS)
    assert m["prior_host_ms_per_audio_s.bulk"] == pytest.approx(37 / 2, abs=1e-3)
    assert m["fetch_wait_ms_per_audio_s.bulk"] == pytest.approx(25 / 2, abs=1e-3)
    assert m["launches_per_plan.bulk"] == 8 and m["syncs_per_plan.bulk"] == 5
    assert m["engine_idle_pct.bulk"] == pytest.approx(100 * 28 / 120, abs=1e-3)
    assert out["marker_margin_s"] == pytest.approx(0.0005, abs=1e-6)
    assert out["fetch_margin_s"] == pytest.approx(0.001, abs=1e-6)
    assert out["spans"]["prior"]["n"] == 2 and out["calls"] == 1


def test_checks_fail_when_the_clocks_disagree():
    late = [dict(s, start_ns=s["start_ns"] + 2 * MS, end_ns=s["end_ns"] - 2 * MS)
            if s["name"] in ("prior", "engine.fetch") else s for s in SPANS]
    out = spans.reduce(_ops(), LABELS, dict(DRAINED, spans=late), _s(-10), _s(110),
                       {"audio_s": 2.0})
    assert out["marker_margin_s"] < 0 and out["fetch_margin_s"] < 0


def test_other_threads_and_unpaired_copies():
    other = SPANS + [_span(11, "prior", 30, 95, thread=2)]
    out = spans.reduce(_ops()[:-1], LABELS, dict(DRAINED, spans=other), _s(-10), _s(110),
                       {"audio_s": 2.0})
    assert out["spans"]["prior"]["n"] == 2
    assert out["fetch_margin_s"] is None
    assert spans.reduce(_ops(), LABELS, {"spans": [], "counters": {}}, _s(-10), _s(110),
                        {})["metrics"] == {f"{k}_idle_pct.bulk": 0.0 for k in spans.LAYERS}


def _events(skew_ms, jump_at_ms=None, jump_ms=0.0):
    """``OPS`` with each one's host call: issued 0.01 ms before the device
    starts it (a copy to the host returns 0.01 ms after it ends), on a clock
    ``skew_ms`` ahead of the device's stamps, ``jump_ms`` more from
    ``jump_at_ms`` on."""
    def skew(a):
        return skew_ms + (jump_ms if jump_at_ms is not None and a >= jump_at_ms else 0.0)
    return sorted((_s(a), _s(b), n, _s(a - 0.01 + skew(a)), _s(b + 0.01 + skew(a)))
                  for a, b, n in OPS)


def _bounds_hold(events, shift):
    for (start, end, name, h_start, h_end), d in zip(events, shift):
        assert start + d >= h_start - 1e-6
        if "DtoH" in name:
            assert end + d <= h_end + 1e-6


@pytest.mark.parametrize("skew_ms", [0.4, -0.3, 0.0])
def test_clock_shift_moves_the_device_onto_the_host_clock(skew_ms):
    events = _events(skew_ms)
    shift = spans.clock_shift(events)
    _bounds_hold(events, shift)
    # the device's stamps off by the skew: moved by it, less the call's lead
    assert shift == pytest.approx([(skew_ms - 0.01) * 1e-3] * len(events), abs=1e-6)
    moved = spans.shifted(events, shift)
    assert [n for _, _, n in moved] == [n for _, _, n in _ops()]


@pytest.mark.parametrize("jump_ms", [0.9, -0.9])
def test_clock_shift_is_right_on_both_sides_of_a_jump(jump_ms):
    events = _events(0.2, jump_at_ms=40, jump_ms=jump_ms)
    shift = spans.clock_shift(events)
    _bounds_hold(events, shift)
    for ev, d in zip(events, shift):
        after = ev[0] >= _s(40)
        assert d == pytest.approx((0.2 - 0.01 + (jump_ms if after else 0.0)) * 1e-3, abs=1e-6)


def test_unpaired_operations_take_their_neighbours_shift():
    events = _events(0.4)
    events[3] = events[3][:3] + (None, None)
    shift = spans.clock_shift(events)
    assert shift[3] == pytest.approx(0.39e-3, abs=1e-6)


@pytest.mark.parametrize("name, want", [("prior", "prior"), ("flow", "flow"),
                                        ("vocoder", "vocoder"), ("engine.fetch", "engine"),
                                        ("modes", "engine"), ("outside", "outside")])
def test_layers_of_the_spans(name, want):
    assert spans.layer(name) == want


def _restamped(events, name, at_ms, by_ms):
    """``events`` with the device stamps of the ``name`` operation that
    starts at ``at_ms`` (on the device's clock) moved by ``by_ms``; its
    host call left where it was."""
    out = []
    for ev in events:
        if ev[2] == name and abs(ev[0] - _s(at_ms)) < 1e-6:
            ev = (ev[0] + by_ms * 1e-3, ev[1] + by_ms * 1e-3) + ev[2:]
        out.append(ev)
    return sorted(out, key=lambda ev: ev[0])


def test_clock_checks_agree_with_the_shift_on_one_clock():
    events = _events(0.4)
    shift = spans.clock_shift(events)
    got = spans.clock_checks(events, LABELS, SPANS, shift)
    full = spans.reduce(spans.shifted(events, shift), LABELS, DRAINED, _s(-10), _s(110), {})
    assert got["held_out_s"] == pytest.approx([full["marker_margin_s"], full["fetch_margin_s"]],
                                              abs=1e-6)
    assert got["constant_shift_ms"] == pytest.approx(0.39, abs=1e-3)
    assert got["constant_s"] == pytest.approx(got["held_out_s"], abs=1e-6)


@pytest.mark.parametrize("name, at_ms, by_ms, which", [
    (tracing.MARKER, 27, -2.5, 0),      # a marker stamped before its prior span opened
    ("Memcpy DtoH", 83, 1.5, 1),        # a copy stamped after its fetch span closed
])
def test_clock_checks_are_not_decided_by_the_shift(name, at_ms, by_ms, which):
    events = _restamped(_events(0.0), name, at_ms, by_ms)
    shift = spans.clock_shift(events)
    full = spans.reduce(spans.shifted(events, shift), LABELS, DRAINED, _s(-10), _s(110), {})
    # the full shift bounds each operation by its own call: both checks hold
    assert full["marker_margin_s"] > 0 and full["fetch_margin_s"] > 0
    got = spans.clock_checks(events, LABELS, SPANS, shift)
    assert got["held_out_s"][which] < 0 and got["constant_s"][which] < 0


def test_trace_events_pairs_operations_with_their_calls():
    class Call(_Event):
        def device_type(self):
            return torch.autograd.DeviceType.CPU

    dev = [_Event(4, 16, "conv"), _Event(15, 16, "Memcpy DtoH")]
    dev[0].correlation_id, dev[1].correlation_id = (lambda: 7), (lambda: 8)
    host = [Call(3.9, 4.0, "cudaLaunchKernel"), Call(14, 17, "cudaStreamSynchronize")]
    host[0].correlation_id, host[1].correlation_id = (lambda: 7), (lambda: 8)
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: dev + host)))
    events = spans.trace_events(prof)
    assert [ev[2] for ev in events] == ["conv", "Memcpy DtoH"]
    assert events[0][:2] + events[0][3:] == pytest.approx(
        (_s(4), _s(16), _s(3.9), _s(4.0)), abs=1e-6)
    assert events[1][3:] == (None, None)


def test_span_cost_leaves_the_recorder_off_and_empty():
    import span_trace
    from vispeech_tpu_torch.utils import profiling

    cost = span_trace.span_cost(100)
    assert set(cost) == {"n", "off_us", "on_us"} and cost["n"] == 100
    assert profiling.drain() == {"spans": [], "counters": {}}
    assert profiling.span("x") is profiling.span("y")
