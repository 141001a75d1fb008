"""Kernel B's share of its roofline: the least time its launches of the
traced calls could take (costs.py, from their shapes) over their traced
device time, in %."""


def read(record):
    t = record.get("trace")
    if not t or not t["kernels"]["wn"]:
        return None
    return 100.0 * t["bounds"]["wn"] / t["kernels"]["wn"]
