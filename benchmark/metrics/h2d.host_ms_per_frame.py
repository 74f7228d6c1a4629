"""Host ms a frame in the program's span ``h2d`` under ``serve``: the
serving call's copy of the frame's arrays to the card
(``eval/test_loop.py::make_device_forward``), over the traced frames."""

from benchmark.harness import spans


def read(r: dict):
    return spans.host_ms_per_item(r, "h2d", under="serve")
