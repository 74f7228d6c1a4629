"""Host ms a frame in the program's span ``forward`` (``ISTNet.forward``,
the spans inside it included), over the traced frames."""

from benchmark.harness import spans


def read(r: dict):
    return spans.host_ms_per_item(r, "forward")
