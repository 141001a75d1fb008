"""Traced runs: what the benchmark's own files record around the program.

* ``Probe`` hooks the program's model at the boundaries of its layers.  At
  each boundary it launches a marker (an empty ``torch.cuda._sleep``) and
  notes the layer that starts there; a marker runs in stream order with the
  program's kernels, so every device operation between two markers belongs
  to the layer the first one opened.  The hook on the generator also counts
  the padded frames it is given (rows × frames).  Boundaries: the text
  encoder opens ``prior`` (the duration-only pass and each plan's prior),
  the duration head's end and the generator's end open ``engine`` (the
  engine's host work, fetches and PCM), the flow opens ``flow``, the
  generator opens ``vocoder``.
* ``device_trace`` reduces the profiler's device operations over a window
  of whole engine calls: the union of their intervals (busy time), each
  layer's device time, each kernel family's, the top operations by time
  and the idle time by the layer the host was in.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional

import torch

MARKER = "spin_kernel"
# the program's kernels by the CUDA function names it launches
KERNEL_NAMES = {"attn": ("rel_attention_kernel", "rel_attention_merge"),
                "wn": ("wn_stack_kernel",),
                "mrf": ("mrf_stage_kernel", "mrf_folded_kernel")}
BOUNDARIES = (("enc_p", "pre", "prior"), ("duration_predictor", "post", "engine"),
              ("flow", "pre", "flow"), ("dec", "pre", "vocoder"), ("dec", "post", "engine"))
LAYERS = ("prior", "flow", "vocoder", "engine")


class Probe:
    """Hooks on ``model`` (the program's Synthesizer) for a traced run.
    Markers and counts are taken only while ``recording`` is set."""

    def __init__(self, model: torch.nn.Module):
        self.labels: List[str] = []
        self.padded_frames = 0
        self.recording = False
        self.handles = []
        for attr, when, label in BOUNDARIES:
            mod = getattr(model, attr)
            if when == "pre":
                hook = self._pre_hook(label, attr == "dec")
                self.handles.append(mod.register_forward_pre_hook(hook))
            else:
                self.handles.append(mod.register_forward_hook(self._post_hook(label)))

    def _mark(self, label: str) -> None:
        self.labels.append(label)
        torch.cuda._sleep(0)

    def _pre_hook(self, label: str, count_frames: bool):
        def hook(_mod, args):
            if self.recording:
                if count_frames:
                    self.padded_frames += args[0].shape[0] * args[0].shape[1]
                self._mark(label)
        return hook

    def _post_hook(self, label: str):
        def hook(_mod, _args, _out):
            if self.recording:
                self._mark(label)
        return hook

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def _device_ops(prof) -> List[tuple]:
    """(start_s, end_s, name) of every kernel, copy and fill on the device."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        ops.append((start, start + e.duration_ns() * 1e-9, e.name()))
    ops.sort()
    return ops


def short_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)[:64]


def device_trace(prof, labels: List[str], window_s: float) -> Dict:
    """The reduction of one traced window (see the module docstring).
    Layer times are left out (None) when the markers found do not match
    the boundaries the probe noted."""
    ops = _device_ops(prof)
    marks = [op for op in ops if MARKER in op[2]]
    work = [op for op in ops if MARKER not in op[2]]
    by_name: Dict[str, float] = {}
    kernels = {k: 0.0 for k in KERNEL_NAMES}
    for start, end, name in work:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        for fam, names in KERNEL_NAMES.items():
            if any(n in name for n in names):
                kernels[fam] += end - start
    busy, cur_start, cur_end = 0.0, None, None
    gaps: List[tuple] = []   # (start, seconds)
    for start, end, _ in work:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
                gaps.append((cur_end, start - cur_end))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    layers: Optional[Dict[str, float]] = None
    idle: Dict[str, float] = {}
    if marks and len(marks) == len(labels):
        starts = [m[0] for m in marks]
        layers = {name: 0.0 for name in LAYERS}

        def label_at(t):
            i = bisect.bisect_right(starts, t) - 1
            return "engine" if i < 0 else labels[i]

        for start, end, _ in work:
            layers[label_at(start)] += end - start
        for start, secs in gaps:
            key = label_at(start)
            idle[key] = idle.get(key, 0.0) + secs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy, "layers": layers, "kernels": kernels,
            "device_ops": [[short_name(n), s] for n, s in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
            "markers": [len(marks), len(labels)]}

