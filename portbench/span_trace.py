#!/usr/bin/env python3
"""A traced run of one cell with the program's span recorder on.

    python3 portbench/span_trace.py --workload <name> --seed <n> --seconds <s>

Runs ``run.py``'s traced run (``--trace 1``: the profiler over the window,
the probe's markers) with ``vispeech_tpu_torch.utils.profiling`` enabled
from the window's start to its end, and adds ``spans.reduce`` of the
window to what ``run.py`` prints: the device's idle time by the host's
innermost span, the counters, the per-span times, the clock checks and
the per-layer numbers of ``spans.METRICS``.  Standard output ends with
``run.py``'s result line, then one line ``{"spans": ..., "span_cost": ...}``;
``span_cost`` is the host's µs a ``span()`` enter and exit over
``SPAN_COST_N`` spans, recorder off and on.

This is ``run.py --trace 1`` with two of its globals replaced; it goes
once ``run.py``'s ``Tracer`` enables and drains the recorder itself.

The spans' clock and the profiler's host clock agree; the profiler's
device stamps can lie a fraction of a millisecond off its own host stamps.
So the device's operations are first moved onto the host's clock by
``spans.clock_shift``, measured from the host calls that issued them;
``clock`` gives both clock checks on the device's own stamps, on the
host calls' (a marker's launch against its span, a copy's call return
against its span) and as ``spans.clock_checks`` makes them, the split
under its constant offset (``constant_idle_pct``), and the shift's 1st,
50th and 99th percentiles.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import run  # noqa: E402
import spans  # noqa: E402
import tracing  # noqa: E402
from vispeech_tpu_torch.utils import profiling  # noqa: E402

SPAN_COST_N = 10 ** 5


class SpanTracer(run.Tracer):
    """``run.Tracer`` that also records the program's spans over the window,
    and the window's ends on their clock."""

    def start(self) -> None:
        profiling.enable()
        super().start()
        self.t0 = self.t_start + (profiling.clock_ns() - time.perf_counter_ns()) * 1e-9

    def stop(self) -> None:
        super().stop()
        profiling.disable()
        self.drained = profiling.drain()


def span_cost(n: int = SPAN_COST_N) -> dict:
    """µs a ``span()`` enter and exit over ``n`` spans, off and on."""
    def time_spans():
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("engine.plan"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"n": n, "off_us": time_spans()}
    profiling.enable()
    out["on_us"] = time_spans()
    profiling.disable()
    profiling.drain()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    cost = span_cost()
    got = {}
    trace_record = run.trace_record

    def traced(tracer, window, recorder, cfg):
        t = trace_record(tracer, window, recorder, cfg)
        events = spans.trace_events(tracer.prof)
        shift = spans.clock_shift(events)
        labels, program = tracer.probe.labels, tracer.drained["spans"]

        def margins(starts, ends):
            """(marker, fetch) margins for markers starting and copies ending at these times."""
            return [spans.marker_margin(starts, labels, program),
                    spans.fetch_margin(ends, program)]

        def reduced(d):
            return spans.reduce(spans.shifted(events, d), labels, tracer.drained,
                                tracer.t0, tracer.t0 + tracer.window_s, t)

        got.update(reduced(shift))
        marks = [ev for ev in events if tracing.MARKER in ev[2]]
        copies = [ev for ev in events if "DtoH" in ev[2]]
        got["clock"] = {
            "device_unshifted_s": margins([ev[0] for ev in marks], [ev[1] for ev in copies]),
            "host_calls_s": margins([ev[3] for ev in marks if ev[3] is not None],
                                    [ev[4] for ev in copies if ev[4] is not None]),
            "shift_ms": [1e3 * q for q in statistics.quantiles(shift, n=100)[::49]]
            if len(shift) > 1 else [],
            "unpaired": sum(ev[3] is None for ev in events),
            **spans.clock_checks(events, labels, program, shift)}
        got["clock"]["constant_idle_pct"] = reduced(
            [got["clock"]["constant_shift_ms"] * 1e-3] * len(events))["idle_pct"]
        got["device_idle_pct"] = 100.0 * (1.0 - t["busy_s"] / t["window_s"])
        got["frames_padded"] = [got["counters"].get("frames_padded"), t["frames_padded"]]
        got["audio_s_per_s"] = t["audio_s"] / t["window_s"]
        return t

    run.Tracer = SpanTracer
    run.trace_record = traced
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    print(json.dumps({"spans": got, "span_cost": cost}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
