"""Traced runs with the program's own spans: the device's idle time split by
what the host was doing.

The program (``vispeech_tpu_torch.utils.profiling``) stamps its spans on
the clock ``torch.profiler`` stamps device operations with (Unix-epoch
time), so both sit on one timeline.  ``host_timeline`` cuts the spans of
one thread into pieces, each under the innermost span open there;
``idle_intervals`` gives the stretches of the window in which no device
operation ran (``tracing.device_trace``'s idle: its gaps, and the window's
head and tail); ``split_idle`` charges each stretch to the pieces it
crosses, and what no span covers to ``outside`` (the harness between
engine calls).  ``reduce`` adds the counters, the per-span times, two
checks of the shared clock and the per-layer numbers in ``METRICS``.

The profiler's device stamps drift from its host stamps (by up to ms in
a 45 s window on the H100), so ``trace_events`` pairs each device
operation with the host call that issued it, ``clock_shift`` measures
from those pairs how far to move each one onto the host's clock, and
``shifted`` moves them.  ``clock_checks`` makes the two checks of the
shared clock on shifts that the checked operations do not bound, and on
one constant offset.

Layers: ``prior``, ``flow`` and ``vocoder`` are the spans of those names;
every other span's self time (the ``engine.*`` spans, and ``modes``: the
model's switches to eval mode and back around each inference method) is
``engine``.
"""

from __future__ import annotations

import statistics
from typing import Container, Dict, List, Optional, Sequence, Tuple

from tracing import MARKER

OUTSIDE = "outside"
LAYERS = ("prior", "flow", "vocoder", "engine")
# device-to-host copies each blocking span of the bulk path (``synthesize_batch``)
# waits on: the duration pass's frame counts; a plan's PCM, durations, f0, energy
SYNCS = {"engine.durations": 1, "engine.fetch": 4}
# the host calls that issue a device operation
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaMemcpyAsync", "cudaMemsetAsync")
METRICS = ("prior_idle_pct.bulk", "flow_idle_pct.bulk", "vocoder_idle_pct.bulk",
           "engine_idle_pct.bulk", "prior_host_ms_per_audio_s.bulk",
           "fetch_wait_ms_per_audio_s.bulk", "launches_per_plan.bulk", "syncs_per_plan.bulk")

Piece = Tuple[float, float, str]


def layer(name: str) -> str:
    return name if name in (*LAYERS[:3], OUTSIDE) else "engine"


def host_timeline(spans: Sequence[Dict]) -> List[Piece]:
    """(start_s, end_s, name) pieces in time order: each stretch under the
    innermost open span.  ``spans`` are of one thread, so they nest."""
    out: List[Piece] = []
    stack: List[Tuple[float, str]] = []     # (end_s, name) of the open spans
    t = 0.0
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        start = s["start_ns"] * 1e-9
        while stack and stack[-1][0] <= start:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, start, stack[-1][1]))
        stack.append((s["end_ns"] * 1e-9, s["name"]))
        t = start
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_intervals(ops: Sequence[Tuple[float, float, str]], t0: float,
                   t1: float) -> List[Tuple[float, float]]:
    """The stretches of [t0, t1] in which no device operation (markers
    left out) ran; ``ops`` sorted by start."""
    out = []
    cur = t0
    for start, end, name in ops:
        if MARKER in name:
            continue
        if start > cur:
            out.append((cur, min(start, t1)))
        cur = max(cur, end)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def split_idle(idle: Sequence[Tuple[float, float]], pieces: Sequence[Piece]) -> Dict[str, float]:
    """Seconds of ``idle`` under each span name, and ``outside`` any."""
    out: Dict[str, float] = {OUTSIDE: 0.0}
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + (hi - lo)
                covered += hi - lo
            k += 1
        out[OUTSIDE] += (b - a) - covered
    return out


def marker_margin(starts: Sequence[float], labels: Sequence[str],
                  spans: Sequence[Dict]) -> Optional[float]:
    """Least start of a ``prior`` marker (``starts``: every marker's, in
    launch order) less the host start of the ``prior`` span it was launched
    in (each such span launches one); None where they do not pair up."""
    if len(starts) != len(labels):
        return None
    marks = [t for t, label in zip(starts, labels) if label == "prior"]
    priors = sorted(s["start_ns"] * 1e-9 for s in spans if s["name"] == "prior")
    if not marks or len(marks) != len(priors):
        return None
    return min(m - s for m, s in zip(marks, priors))


def _copy_spans(spans: Sequence[Dict]) -> List[Tuple[int, Dict]]:
    """(k, span) of each device-to-host copy, in order: the k-th blocking
    span (``SYNCS``), which waited on it."""
    blocking = [s for s in sorted(spans, key=lambda s: s["start_ns"]) if s["name"] in SYNCS]
    return [(k, s) for k, s in enumerate(blocking) for _ in range(SYNCS[s["name"]])]


def fetch_margin(ends: Sequence[float], spans: Sequence[Dict],
                 which: Optional[Container[int]] = None) -> Optional[float]:
    """Least host end of a blocking span less the end of a device-to-host
    copy it waited on (``ends``: every copy's, in order; ``which``: the
    positions of the copies checked, all where None); None where their
    numbers differ or none is checked."""
    pairs = _copy_spans(spans)
    if not ends or len(ends) != len(pairs):
        return None
    margins = [s["end_ns"] * 1e-9 - e for j, ((_, s), e) in enumerate(zip(pairs, ends))
               if which is None or j in which]
    return min(margins) if margins else None


def trace_events(prof) -> List[Tuple]:
    """Every device operation of a profile in start order, as
    ``tracing.device_trace`` reads them, with the host call that issued it
    (paired by correlation id): (start_s, end_s, name, call_start_s,
    call_end_s), the call's times None where the profiler pairs none."""
    import torch

    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.name() in LAUNCHES:
            host[e.correlation_id()] = e
    out = []
    for e in dev:
        start = e.start_ns() * 1e-9
        h = host.get(e.correlation_id())
        h_start = None if h is None else h.start_ns() * 1e-9
        out.append((start, start + e.duration_ns() * 1e-9, e.name(), h_start,
                    None if h is None else h_start + h.duration_ns() * 1e-9))
    out.sort(key=lambda ev: ev[0])
    return out


def clock_shift(events: Sequence[Tuple], held_out: Container[int] = ()) -> List[float]:
    """Seconds to add to each device operation of ``events`` to put it on
    the host's clock.  The profiler's device stamps drift from its host
    stamps and jump; the host's calls bound the shift: no operation starts
    before its call starts, and no copy to the host ends after its call
    returns (the program copies to pageable memory, and such a call returns
    once the copy is done).  A sweep forward keeps the least shift that
    meets the bounds seen so far (it follows a rising skew at once, a
    falling one at the next copy); a sweep backward does the same from the
    end; each operation takes the smaller, right on either side of a jump.
    The operations at the indices ``held_out`` bound nothing: each takes
    the shift of those before it in the sweep (after it, at the start)."""
    def sweep(order):
        out: List[Optional[float]] = [None] * len(events)
        s = None
        for i in order:
            start, end, name, h_start, h_end = events[i]
            if h_start is None or i in held_out:
                out[i] = s
                continue
            if s is None:
                s = h_start - start
            if "DtoH" in name:
                s = min(s, h_end - end)
            s = max(s, h_start - start)
            out[i] = s
        return out

    n = len(events)
    return [min((d for d in fb if d is not None), default=0.0)
            for fb in zip(sweep(range(n)), sweep(range(n - 1, -1, -1)))]


def shifted(events: Sequence[Tuple], shift: Sequence[float]) -> List[Tuple[float, float, str]]:
    """(start_s, end_s, name) of ``events``, each moved by its shift."""
    return sorted((ev[0] + d, ev[1] + d, ev[2]) for ev, d in zip(events, shift))


def reduce(ops, labels: Sequence[str], drained: Dict, t0: float, t1: float,
           trace: Dict) -> Dict:
    """The reduction of one traced window [t0, t1] (epoch seconds).
    ``ops``: the device's operations (start_s, end_s, name) in start order
    on the host's clock (``shifted``); ``labels``: the probe's;
    ``drained``: the program's ``profiling.drain()``; ``trace``:
    ``tracing.device_trace``'s record with ``audio_s``."""
    counters = drained["counters"]
    threads = [s["thread"] for s in drained["spans"] if s["name"] == "engine.call"]
    main = max(set(threads), key=threads.count) if threads else None
    program = [s for s in drained["spans"] if s["thread"] == main]
    window = t1 - t0
    idle = idle_intervals(ops, t0, t1)
    by_name = split_idle(idle, host_timeline(program))
    by_layer = {k: 0.0 for k in (*LAYERS, OUTSIDE)}
    for name, secs in by_name.items():
        by_layer[layer(name)] = by_layer.get(layer(name), 0.0) + secs
    idle_pct = {k: 100.0 * v / window for k, v in by_layer.items()}
    times: Dict[str, Dict[str, float]] = {}
    for s in program:
        t = times.setdefault(s["name"], {"n": 0, "total_s": 0.0, "self_s": 0.0})
        t["n"] += 1
        t["total_s"] += (s["end_ns"] - s["start_ns"]) * 1e-9
        t["self_s"] += s["self_ns"] * 1e-9
    for name, t in times.items():
        t["idle_s"] = by_name.get(name, 0.0)
    plans = counters.get("plans", 0)
    audio_s = trace.get("audio_s") or 0.0
    launches = sum(1 for op in ops if MARKER not in op[2] and t0 <= op[0] <= t1)
    metrics = {f"{key}_idle_pct.bulk": idle_pct[key] for key in LAYERS}
    if audio_s:
        metrics["prior_host_ms_per_audio_s.bulk"] = (
            1e3 * times.get("prior", {}).get("self_s", 0.0) / audio_s)
        metrics["fetch_wait_ms_per_audio_s.bulk"] = (
            1e3 * times.get("engine.fetch", {}).get("total_s", 0.0) / audio_s)
    if plans:
        metrics["launches_per_plan.bulk"] = launches / plans
        metrics["syncs_per_plan.bulk"] = counters.get("syncs", 0) / plans
    return {"window_s": window, "idle_s": sum(b - a for a, b in idle),
            "idle_pct": idle_pct, "idle_by_span_s": by_name, "spans": times,
            "counters": counters, "calls": len(threads), "launches": launches,
            "marker_margin_s": marker_margin([op[0] for op in ops if MARKER in op[2]], labels,
                                             program),
            "fetch_margin_s": fetch_margin([op[1] for op in ops if "DtoH" in op[2]], program),
            "metrics": metrics}


def clock_checks(events: Sequence[Tuple], labels: Sequence[str], program: Sequence[Dict],
                 shift: Sequence[float]) -> Dict:
    """The two clock checks made so that the shift does not decide them.
    On ``shift`` (``clock_shift`` of all ``events``) they hold by
    construction: it puts no marker before its launch call, and no copy
    after its call's return.  ``held_out_s``: (markers, copies) margins,
    the markers' on a shift that no marker bounds, the copies' on two
    shifts, each bound by the copies of every other blocking span and
    checking the rest.  ``constant_s``: both margins with every operation
    moved by one offset, ``constant_shift_ms``, the median of ``shift``."""
    marks = {i for i, ev in enumerate(events) if MARKER in ev[2]}
    copies = [i for i, ev in enumerate(events) if "DtoH" in ev[2]]

    def margins(d, which=None):
        ops = shifted(events, d)
        return (marker_margin([op[0] for op in ops if MARKER in op[2]], labels, program),
                fetch_margin([op[1] for op in ops if "DtoH" in op[2]], program, which))

    marker = margins(clock_shift(events, marks))[0]
    pairs = _copy_spans(program)
    fetch = []
    if len(pairs) == len(copies):
        for parity in (0, 1):
            which = {j for j, (k, _) in enumerate(pairs) if k % 2 == parity}
            got = margins(clock_shift(events, {copies[j] for j in which}), which)[1]
            if got is not None:
                fetch.append(got)
    offset = statistics.median(shift) if shift else 0.0
    return {"held_out_s": [marker, min(fetch) if fetch else None],
            "constant_shift_ms": 1e3 * offset,
            "constant_s": list(margins([offset] * len(events)))}
