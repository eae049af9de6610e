"""Megabytes a volume moves between host and card, from the port's
counters over the whole run: ``copy.h2d_bytes`` and ``copy.d2h_bytes``
(every move of the stylize, the loader, the harness and the sliding
window) over ``eval.volumes`` (the rows the harness evaluated)."""

from portbench import spans


def read(record):
    c = spans.program_counters()
    if not c.get("eval.volumes"):
        return None
    return 1e-6 * (c.get("copy.h2d_bytes", 0) + c.get("copy.d2h_bytes", 0)) / c["eval.volumes"]
