"""Share of the bytes moved between host and card that moved from or into
page-locked host memory, from the port's counters over the whole run:
``copy.h2d_pinned_bytes`` and ``copy.d2h_pinned_bytes`` over
``copy.h2d_bytes`` and ``copy.d2h_bytes``, in %. None where the port
counts no page-locked bytes."""

from portbench import spans


def read(record):
    c = spans.program_counters()
    pinned = ("copy.h2d_pinned_bytes", "copy.d2h_pinned_bytes")
    total = c.get("copy.h2d_bytes", 0) + c.get("copy.d2h_bytes", 0)
    if not total or not any(k in c for k in pinned):
        return None
    return 100.0 * sum(c.get(k, 0) for k in pinned) / total
