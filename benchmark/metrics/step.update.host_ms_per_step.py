"""Host ms a train step in the program's span ``step.update``: Adam and
the BN EMA (``train_state.finish_step``), over the traced steps."""

from benchmark.harness import spans


def read(r: dict):
    return spans.host_ms_per_item(r, "step.update")
