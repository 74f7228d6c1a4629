"""``kernels.roofline_share.infer``, read in the train cells, which
report another end-to-end metric."""

from benchmark.harness import manifest

read = manifest.reader("kernels.roofline_share.infer").read
