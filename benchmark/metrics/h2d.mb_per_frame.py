"""MB (1e6 bytes) a frame that the serving call hands over from host
memory: the program's counters ``h2d.bytes`` over ``serve.frames``, over
the process (every frame of it comes from the cell's traffic). Without
the counters, or with no frame served, nothing."""

from benchmark.harness import spans


def read(r: dict):
    c = spans.counters()
    if not c or not c.get("serve.frames"):
        return None
    return c.get("h2d.bytes", 0) / c["serve.frames"] / 1e6
