"""SwinUNETR's window attention's share of its roofline: the least time of
the traced forward attention calls, each block's function counted by
``portbench/swin_work.py`` at the cell's batch and crop (operations of
``q k^T`` and ``attn @ v``; ``q``, ``k``, ``v``, the output, the bias and
the mask read or written once in bfloat16; against the bf16 peak and the
memory bandwidth of ``portbench/roofline.py``), times the traced
``mvtb.step`` spans, over the device time of the records launched inside
the port's ``mvtb.swin.attn`` spans. Spans cannot see the backward, which
autograd runs on its own thread: this is the forward's share."""

from portbench import spans, swin_work


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.swin.attn"):
        return None
    ms = spans.device_ms_under(trace, "mvtb.swin.attn")
    if not ms:
        return None
    wl = record["workload"]
    least = swin_work.attn_least_seconds(record["config"]["model"], wl["spatial"], wl["batch"])
    return 100.0 * least * steps / (1e-3 * ms)
