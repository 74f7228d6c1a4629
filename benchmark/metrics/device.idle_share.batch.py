"""``device.idle_share.infer``, read in the cells of batched crops,
which report another end-to-end metric."""

from benchmark.harness import manifest

read = manifest.reader("device.idle_share.infer").read
