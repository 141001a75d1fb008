"""Kernels C and D's share of their roofline: the least time their launches of the
traced calls could take (costs.py, from their shapes) over their traced
device time, in %."""


def read(record):
    t = record.get("trace")
    if not t or not t["kernels"]["mrf"]:
        return None
    return 100.0 * t["bounds"]["mrf"] / t["kernels"]["mrf"]
