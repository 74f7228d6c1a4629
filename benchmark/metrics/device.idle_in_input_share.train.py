"""Share (%) of the device's idle time in the traced window during which
the host was inside the program's span ``h2d`` or ``step.prepare``, or a
span under them: the idle that only the input side (the copy, the device
pipeline) can take away, which a CUDA graph of the step would leave."""

from benchmark.harness import spans


def read(r: dict):
    return spans.idle_share(r, ("h2d", "step.prepare"))
