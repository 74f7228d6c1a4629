"""Model FLOPs of the poses delivered in the untraced window, over the
window's length times the dense peak of the serving precision (%)."""

from benchmark.harness.roofline import PEAK_OPS


def read(r: dict):
    poses = r["counts"].get("poses")
    if not poses:
        return None
    return (100.0 * r["flops_forward"] * poses
            / (r["window_s"] * PEAK_OPS[r["precision"]]))
