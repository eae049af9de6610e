"""The share of the tokens SwinUNETR's window attention attends that are
real, from the port's counters over the whole run: ``swin.tokens`` (the
grid's tokens entering each block) over ``swin.window_tokens`` (the
padded grid's, every one a key, a value and a query), in %."""

from portbench import spans


def read(record):
    c = spans.program_counters()
    if not c.get("swin.window_tokens"):
        return None
    return 100.0 * c.get("swin.tokens", 0) / c["swin.window_tokens"]
