"""Device time of the flow (between the probe's markers) per second of
audio served by the traced engine calls, in ms."""


def read(record):
    t = record.get("trace")
    if not t or not t["layers"] or not t["audio_s"]:
        return None
    return 1e3 * t["layers"]["flow"] / t["audio_s"]
