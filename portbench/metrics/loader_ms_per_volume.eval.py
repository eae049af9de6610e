"""Host milliseconds the stylized loader takes to hand the harness a
volume: the benchmark's span around each ``next()`` of the loader it
passes to ``ModelEvaluation``, the stylize on the card and the copy back to
numpy included, averaged over the window's volumes."""


def read(record):
    spans = record["spans"].get("loader_next")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
