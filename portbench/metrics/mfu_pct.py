"""The model FLOPs of the requests served by the traced calls (costs.py:
real phonemes, frames and samples, not the padding) over the traced
window's wall time at the card's bf16 dense peak, in %."""

from costs import PEAKS


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"] or not t["model_flops"]:
        return None
    return 100.0 * t["model_flops"] / (t["window_s"] * PEAKS["bf16"])
