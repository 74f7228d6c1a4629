"""Host ms a train step in the program's span ``h2d``: the batch's pinned
copy to the card (``train/solver.py::to_device``), over the traced
steps."""

from benchmark.harness import spans


def read(r: dict):
    return spans.host_ms_per_item(r, "h2d")
