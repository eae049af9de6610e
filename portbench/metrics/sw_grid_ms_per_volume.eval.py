"""Host milliseconds a volume spends in the port's ``mvtb.sw.grid`` span:
the sliding window's tile grid, importance map and blend normalizer built
on the host in numpy, and their moves to the card, over the traced
volumes."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    n = spans.volumes(trace)
    if not n or not spans.count(trace, "mvtb.sw.grid"):
        return None
    return spans.host_ms(trace, "mvtb.sw.grid") / n
