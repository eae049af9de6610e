"""Kernels the optimizer launches a training step: the traced kernel
records launched inside the port's ``mvtb.step.optimizer`` span, over the
traced ``mvtb.step`` spans."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.step.optimizer"):
        return None
    return len(spans.under(trace, "mvtb.step.optimizer", ("kernel",))) / steps
