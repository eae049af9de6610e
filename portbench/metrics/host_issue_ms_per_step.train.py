"""Host milliseconds a training step takes to issue: the host clock around
each chunk call, before its loss read, summed over the window's chunks and
divided by their steps. Near the step's wall time the host sets the pace."""


def read(record):
    spans = record["spans"].get("chunk_issue")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / sum(n for _, n in spans)
