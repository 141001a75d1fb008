"""Real frames (the served durations) over the padded rows × frames the
generator was given, over the traced engine calls, in %."""


def read(record):
    t = record.get("trace")
    if not t or not t["frames_padded"]:
        return None
    return 100.0 * t["frames_real"] / t["frames_padded"]
