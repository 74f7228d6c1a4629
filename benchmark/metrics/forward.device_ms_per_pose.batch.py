"""``forward.device_ms_per_pose``, read in the cells of batched crops,
which report another end-to-end metric."""

from benchmark.harness import manifest

read = manifest.reader("forward.device_ms_per_pose").read
