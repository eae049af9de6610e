"""The device's idle share over the traced window: one less the union of
the intervals in which a kernel, copy or fill ran, over the window."""

from portbench.trace import busy_seconds, window_seconds


def read(record):
    trace = record.get("trace")
    if not trace or not trace["device"]:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / window_seconds(trace))
