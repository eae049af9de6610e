"""Device milliseconds a training step spends in SegMamba's token layout:
the traced records launched inside the port's ``mvtb.mamba.layout`` spans
(the tokens' transpose for the LayerNorm, the flips, the slice transposes
and their inverses), over the traced ``mvtb.step`` spans. Spans cannot see
the backward, which autograd runs on its own thread: this is the
forward's device time."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.mamba.layout"):
        return None
    return spans.device_ms_under(trace, "mvtb.mamba.layout") / steps
