"""Device milliseconds a training step spends in SegMamba's selective scan:
the traced kernels whose names are the scan's (``selective_scan_*``,
forward and backward; ``portbench/scan_work.py:device_ms``), over the
traced ``mvtb.step`` spans."""

from portbench import scan_work, spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    ms = scan_work.device_ms(trace)
    if not steps or not ms:
        return None
    return ms / steps
