"""What the ablation tools share: copies of a kernel's source with parts
taken out, built by nvcc side by side, each bound in turn in the wrapper's
place, and a call's device time on the card."""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from vispeech_tpu_torch.ops.kernels import _build


def build(source: str, variants: dict, root) -> dict:
    """Each variant of ``csrc/<source>.cu`` (a list of (old, new) text
    replacements) built at once into ``root`` → its loaded library."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant '{name}': the source no longer has {old[:60]!r}")
            text = text.replace(old, new)
        stem = re.sub(r"\W+", "_", name).strip("_")
        cu, so = root / f"{stem}.cu", root / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant '{name}':\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, source: str, symbols: dict) -> None:
    """Let the wrapper of ``source`` call ``lib``'s functions (symbol →
    argtypes) until ``_build._FUNCS`` is cleared."""
    for symbol, argtypes in symbols.items():
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _build._FUNCS[(source, symbol)] = fn


def device_ms(fn, reps: int) -> float:
    """``fn``'s device time per call, in ms: the stream sleeps first, so the
    host has queued every call before the first one runs."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
