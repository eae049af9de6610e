"""The fused plane kernel's share of its roofline: the least time its
function needs at the traced call's shape (``portbench/roofline.py``), over
the kernel's mean device time in the trace."""

from portbench.roofline import plane_least_seconds

KERNEL = "fused_plane_kernel"


def read(record):
    trace, shape = record.get("trace"), record["counters"].get("plane_shape")
    if not trace or not shape:
        return None
    durs = [e["dur"] for e in trace["device"] if KERNEL in e["name"]]
    if not durs:
        return None
    return 100.0 * plane_least_seconds(shape) / (1e-6 * sum(durs) / len(durs))
