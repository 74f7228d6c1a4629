"""Model FLOPs of the samples trained in the untraced window (3 x the
trained modules' forward, 1 x a frozen enhancer's), over the window's
length times the dense peak of the training precision (%)."""

from benchmark.harness.roofline import PEAK_OPS


def read(r: dict):
    samples = r["counts"].get("samples")
    if not samples:
        return None
    return (100.0 * r["flops_train_sample"] * samples
            / (r["window_s"] * PEAK_OPS[r["precision"]]))
