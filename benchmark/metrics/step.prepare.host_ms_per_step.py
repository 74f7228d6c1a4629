"""Host ms a train step in the program's span ``step.prepare``: the
step's input pipeline (``train_state.prepare_batch``: the device fill,
crop, sampling, jitter and augmentation), over the traced steps."""

from benchmark.harness import spans


def read(r: dict):
    return spans.host_ms_per_item(r, "step.prepare")
