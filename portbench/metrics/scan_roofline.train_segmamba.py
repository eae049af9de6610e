"""SegMamba's selective scan's share of its roofline: the least time of the
traced steps' scans, forward and backward (``portbench/scan_work.py``:
each scan's function counted from the configuration's widths, the cell's
batch and crop, each input and output once in its type; against the bf16
peak and the memory bandwidth of ``portbench/roofline.py``), times the
traced ``mvtb.step`` spans, over the device time of the kernels whose
names are the scan's (``selective_scan_*``). It reads kernel names, not
spans, so it sees the backward that autograd runs on its own thread."""

from portbench import scan_work, spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    ms = scan_work.device_ms(trace)
    if not steps or not ms:
        return None
    wl, cfg = record["workload"], record["config"]
    least = scan_work.step_least_seconds(cfg["model"], wl["spatial"], wl["batch"],
                                         cfg["precision"]["model"])
    return 100.0 * least * steps / (1e-3 * ms)
