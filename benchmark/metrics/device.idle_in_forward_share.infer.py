"""Share (%) of the device's idle time in the traced window during which
the host was inside the program's span ``forward`` or a span under it:
the idle that a CUDA graph of the forward could take away."""

from benchmark.harness import spans


def read(r: dict):
    return spans.idle_share(r, ("forward",))
