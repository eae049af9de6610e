"""Host milliseconds a volume spends crossing between host and card, in the
port's own spans: ``mvtb.loader.to_host`` (the stylized loader's copy of
its output back to numpy, which waits for the stylize first) and
``mvtb.eval.to_device`` (the harness's image and label moves), over the
traced volumes."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    n = spans.volumes(trace)
    if not n:
        return None
    return spans.host_ms(trace, "mvtb.loader.to_host", "mvtb.eval.to_device") / n
